"""pyEXP.edmd compatibility (port of exp_tpu/pyexp/edmd.py; reference
pyEXP/EDMDWrappers.cc).

Koopman with the reference's constructor convention (config dict of
name -> (Coefs, keys, []) like expMSSA) and camelCase methods, over
exp_tpu_torch.analysis.edmd.Koopman (host NumPy).
"""

from __future__ import annotations

import numpy as np

from exp_tpu_torch.analysis.edmd import Koopman as _NativeKoopman


class Koopman:
    """Reference-shaped extended-DMD driver (expui/Koopman.H:13-61)."""

    def __init__(self, config: dict, numev: int = 10, flags: str = ""):
        self._coefs = {}
        data = {}
        keys = {}
        for name, spec in config.items():
            if isinstance(spec, (tuple, list)):
                coefs = spec[0]
                chans = spec[1] if len(spec) > 1 else None
            else:
                coefs, chans = spec, None
            nat = coefs._c if hasattr(coefs, "_c") else coefs
            self._coefs[name] = coefs
            data[name] = nat
            if chans:
                keys[name] = [tuple(int(i) for i in k) for k in chans]
        self._k = _NativeKoopman(data, numev, keys=keys or None)
        self._modes = None

    def eigenvalues(self):
        return np.asarray(self._k.eigenvalues())

    def getModes(self):
        return np.asarray(self._k.getModes())

    def getAllKeys(self):
        return [(name,) + tuple(
                    int(i) for i in np.unravel_index(
                        j, self._k._shapes[name]))
                for name, j in self._k.keys]

    def reconstruct(self, evlist=None):
        self._modes = (None if evlist is None
                       else [int(i) for i in np.atleast_1d(evlist)])

    def getReconstructedKoopman(self):
        """dict name -> Coefs rebuilt from the selected Koopman modes."""
        rec = self._k.reconstruction(modes=self._modes)   # (C, nt) rows
        out = {}
        for name, coefs in self._coefs.items():
            nat = coefs._c if hasattr(coefs, "_c") else coefs
            new = nat.deepcopy()
            times = new.times()
            A = new.as_array()
            flat = A.reshape(A.shape[0], -1)
            for row, (nm, j) in enumerate(self._k.keys):
                if nm == name:
                    series = np.real(rec[row])
                    n = min(len(series), flat.shape[0])
                    flat[:n, j] = series[:n]
            for i, t in enumerate(times):
                new._data[t] = flat[i].reshape(self._k._shapes[name])
            if hasattr(coefs, "_c"):
                from .coefs import Coefs as _CompatCoefs

                out[name] = _CompatCoefs(new)
            else:
                out[name] = new
        return out

    # reference spelling (EDMDWrappers.cc:213)
    getReconstructed = getReconstructedKoopman

    def channelDFT(self, dt=1.0):
        """DFT of the selected data channels (Koopman::channelDFT,
        expui/Koopman.cc:435-483): (freqs (nfreq,), power (nfreq, nchan)).
        Unlike mSSA there is no meaningful PC-DFT counterpart."""
        D = self._k.D[:self._k.nchan]          # (nchan, T), mean-removed
        T = D.shape[1]
        freq = 2.0 * np.pi * np.fft.rfftfreq(T, d=dt)
        power = (np.abs(np.fft.rfft(D, axis=1)) ** 2 / T).T
        return freq, power

    def contrib(self):
        """Contribution images (Koopman::contributions,
        expui/Koopman.cc:210-287): time-averaged per-(mode, channel)
        reconstruction power |Phi[n,j] amp[j] ev[j]^t|^2, returned as
        (F, G) both (nev, nkeys) — F rows normalized per mode, G columns
        per channel, both in sqrt (amplitude) units."""
        Phi = self._k.modes                    # (nkeys, r) complex
        lam = self._k.ev                       # (r,)
        amp = self._k.amp                      # (r,)
        T = self._k.D.shape[1]
        # per-mode weight w = |amp|^2 * mean_t |lam|^(2t), computed in log
        # space and shifted by the max so a spurious |lam|>1 mode cannot
        # overflow to inf/NaN (a common global factor cancels in both
        # normalizations below)
        logr = 2.0 * np.log(np.maximum(np.abs(lam), 1e-300))
        t = np.arange(T)[:, None]
        tl = t * logr[None, :]                           # (T, r)
        m = tl.max(axis=0)
        logmean = m + np.log(np.exp(tl - m).sum(axis=0)) - np.log(T)
        logw = 2.0 * np.log(np.maximum(np.abs(amp), 1e-300)) + logmean
        w = np.exp(logw - logw.max())
        F = (np.abs(Phi) ** 2 * w).T                     # (r, nkeys)
        G = F.copy()
        rown = F.sum(axis=1, keepdims=True)
        F = np.sqrt(np.divide(F, rown, out=np.zeros_like(F),
                              where=rown > 0))
        coln = G.sum(axis=0, keepdims=True)
        G = np.sqrt(np.divide(G, coln, out=np.zeros_like(G),
                              where=coln > 0))
        return F, G

    def saveState(self, prefix: str):
        np.savez(f"{prefix}_edmd.npz", ev=self._k.eigenvalues(),
                 modes=self._k.getModes())

    def restoreState(self, prefix: str):
        np.load(f"{prefix}_edmd.npz")  # decomposition is cheap; re-derived
