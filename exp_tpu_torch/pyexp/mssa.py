"""pyEXP.mssa compatibility (port of exp_tpu/pyexp/mssa.py; reference
pyEXP/MSSAWrappers.cc).

expMSSA with the reference's constructor convention — config is a dict
  name -> (Coefs, keys, [])
(expMSSA.H:13) — and camelCase methods, delegating to
exp_tpu_torch.analysis.mssa.expMSSA (host NumPy).  wcorrPNG needs
matplotlib.
"""

from __future__ import annotations

import numpy as np

from exp_tpu_torch.analysis.mssa import expMSSA as _NativeMSSA


class expMSSA:
    """Reference-shaped MSSA driver."""

    def __init__(self, config: dict, window: int, numpc: int, flags: str = ""):
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
        self._m = _NativeMSSA(data, window, numpc, keys=keys or None)
        self._groups = None
        # background snapshot for zerodata()/background() round trips
        self._bg = {n: (c._c if hasattr(c, "_c") else c).deepcopy()
                    for n, c in self._coefs.items()}

    # -- decomposition -------------------------------------------------------

    def eigenvalues(self):
        return np.asarray(self._m.eigenvalues())

    def getPC(self):
        return np.asarray(self._m.pcs())

    def cumulative(self):
        """Cumulatively summed eigenvalues (MSSAWrappers.cc:211)."""
        return np.cumsum(np.asarray(self._m.eigenvalues()))

    def getU(self):
        """Left singular vectors (K, numpc)."""
        return np.asarray(self._m.U)

    def contrib(self):
        return np.asarray(self._m.contributions())

    def getTotVar(self):
        return float(sum(np.var(s) for s in self._m._series.values()))

    def getTotPow(self):
        tot = 0.0
        for (name, j), s in self._m._series.items():
            tot += float(np.sum((s + self._m._mean[(name, j)]) ** 2))
        return tot

    def getAllKeys(self):
        """Channel keys as (name, multi-index...) tuples."""
        return [(name,) + tuple(
                    int(i) for i in np.unravel_index(
                        j, self._m._shapes[name]))
                for name, j in self._m.keys]

    def getRCkeys(self):
        return self.getAllKeys()

    def _flat_key(self, key):
        """Accept either the (name, multi-index...) tuples this surface
        hands out (getAllKeys) or the native (name, flat_index) keys, and
        return the native key."""
        key = tuple(key)
        name, idx = key[0], key[1:]
        if len(idx) == 1 and (name, int(idx[0])) in self._m._series:
            return (name, int(idx[0]))
        return (name, int(np.ravel_multi_index(
            [int(i) for i in idx], self._m._shapes[name])))

    # -- DFT diagnostics -----------------------------------------------------

    def pcDFT(self, dt=1.0):
        return self._m.pcDFT(dt)

    def channelDFT(self, dt=1.0):
        return self._m.channelDFT(dt)

    def singleDFT(self, key, dt=1.0):
        return self._m.singleDFT(self._flat_key(key), dt)

    # -- grouping / reconstruction -------------------------------------------

    def reconstruct(self, evlist=None):
        """Select eigentriples for reconstruction (stored; applied in
        getReconstructed, matching the reference's two-step flow)."""
        self._groups = (None if evlist is None
                        else [list(map(int, np.atleast_1d(evlist)))])

    def getRC(self, key=None):
        """Reconstructed channel series (incl. mean) for the current
        selection: dict (name, flat_index) -> (T,) array, or one array
        for `key`."""
        rec = self._m.reconstructed(groups=self._groups)
        if key is not None:
            key = tuple(key)
            return np.asarray(rec[key] if key in rec
                              else rec[self._flat_key(key)])
        return {k: np.asarray(v) for k, v in rec.items()}

    def getReconstructed(self):
        """dict name -> Coefs with the reconstruction applied
        (expMSSA::getReconstructed)."""
        out = {}
        for name, coefs in self._coefs.items():
            nat = coefs._c if hasattr(coefs, "_c") else coefs
            newnat = self._m.reconstruct_coefs(nat, groups=self._groups,
                                               name=name)
            if hasattr(coefs, "_c"):
                from .coefs import Coefs as _CompatCoefs

                out[name] = _CompatCoefs(newnat)
            else:
                out[name] = newnat
        return out

    def background(self):
        """Copy the background (original) coefficient data back into the
        working Coefs — use after zerodata() so the non-analyzed channels
        are included in the reconstruction (expMSSA::background,
        CoefContainer.cc:81)."""
        for name, coefs in self._coefs.items():
            nat = coefs._c if hasattr(coefs, "_c") else coefs
            bg = self._bg[name]
            for t in nat.times():
                nat._data[t] = bg._data[t].copy()
            if hasattr(coefs, "_structs"):
                for t, s in coefs._structs.items():
                    s.coefs = nat._data.get(float(t), s.coefs)

    # -- Koopman modes (eDMD over the embedded channels) ---------------------

    def getKoopmanModes(self, tol=1e-12, window=0, debug=False):
        """(eigenvalues, modes) from eDMD of the delay-embedded channels
        (expMSSA::getKoopmanModes; `window` blending between serialized
        channels is not needed here — channels are embedded independently)."""
        ev, Phi = self._m.koopman_modes(tol)
        return np.asarray(ev), np.asarray(Phi)

    def getReconstructedKoopman(self, mode):
        """dict name -> Coefs holding ONE Koopman mode's reconstruction
        (expMSSA::getReconstructedKoopman)."""
        out = {}
        for name, coefs in self._coefs.items():
            nat = coefs._c if hasattr(coefs, "_c") else coefs
            newnat = self._m.reconstruct_koopman(nat, int(mode), name=name)
            if hasattr(coefs, "_c"):
                from .coefs import Coefs as _CompatCoefs

                out[name] = _CompatCoefs(newnat)
            else:
                out[name] = newnat
        return out

    # -- w-correlation -------------------------------------------------------

    def wCorr(self, name=None, key=None):
        """w-correlation matrix: all channels, one dataset's channels
        (`name`), or one channel (`name` + per-dataset `key`)."""
        if name is not None and key is not None:
            fk = self._flat_key((name,) + tuple(np.atleast_1d(key)))
            return np.asarray(self._m.wcorr(
                channels=[self._m.keys.index(fk)]))
        if name is not None:
            chans = [i for i, (nm, _) in enumerate(self._m.keys)
                     if nm == name]
            return np.asarray(self._m.wcorr(channels=chans))
        return np.asarray(self._m.wcorr())

    def wCorrAll(self):
        return np.asarray(self._m.wcorr())

    def wCorrKey(self, key):
        """w-correlation restricted to one channel key (name, index...)."""
        fk = self._flat_key(key)
        return np.asarray(self._m.wcorr(channels=[self._m.keys.index(fk)]))

    def wcorrPNG(self, prefix="wcorr"):
        """Render the w-correlation matrix to <prefix>.png."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        W = np.asarray(self._m.wcorr())
        fig, ax = plt.subplots(figsize=(5, 4), dpi=120)
        im = ax.imshow(np.abs(W), origin="lower", cmap="viridis",
                       vmin=0, vmax=1)
        ax.set_xlabel("component")
        ax.set_ylabel("component")
        fig.colorbar(im, ax=ax, label="|w-corr|")
        path = f"{prefix}.png"
        fig.savefig(path, bbox_inches="tight")
        plt.close(fig)
        return path

    # -- grouping ------------------------------------------------------------

    def kmeans(self, clusters=4, stride=1, toTerm=False):
        """dict eigentriple -> (cluster id, distance) (expMSSA::kmeans)."""
        ids, dists, tol = self._m.kmeans(clusters, stride=stride)
        return {int(i): (int(c), float(d))
                for i, (c, d) in enumerate(zip(ids, dists))}

    def kmeansChannel(self, key, clusters=4, stride=1):
        ids, dists, tol = self._m.kmeans(clusters, stride=stride,
                                         key=self._flat_key(key))
        return {int(i): (int(c), float(d))
                for i, (c, d) in enumerate(zip(ids, dists))}

    # -- state ---------------------------------------------------------------

    def saveState(self, prefix: str):
        """Persist the decomposition to <prefix>_mssa.npz."""
        np.savez(f"{prefix}_mssa.npz",
                 U=self._m.U, S=self._m.S, Vt=self._m.Vt,
                 window=self._m.window, numpc=self._m.numpc)

    def restoreState(self, prefix: str):
        d = np.load(f"{prefix}_mssa.npz")
        if (int(d["window"]) != self._m.window
                or int(d["numpc"]) != self._m.numpc):
            raise ValueError("saved state does not match this expMSSA "
                             "configuration")
        self._m.U, self._m.S, self._m.Vt = d["U"], d["S"], d["Vt"]
        self._m.PC = self._m.U * self._m.S
