"""Koopman / extended DMD (pyEXP `edmd` submodule).

A host-side NumPy copy of exp_tpu/analysis/edmd.py (the port imports
nothing of exp_tpu).

The analogue of expui/Koopman (Koopman.H:13-61): exact DMD over coefficient
time series — SVD-truncated least-squares propagator, Koopman eigenvalues,
modes, and reconstruction.
"""

from __future__ import annotations

import numpy as np


class Koopman:
    """Exact DMD on coefficient series.

    Args:
      data: dict name -> Coefs (or (T, channels) arrays).
      numev: SVD truncation rank.
    """

    def __init__(self, data: dict, numev: int, keys=None, window: int = 1):
        """window > 1 enables Hankel (time-delay) embedding — needed when the
        number of channels is smaller than the spectral complexity."""
        self.numev = int(numev)
        self.window = int(window)
        cols = []
        self.keys = []
        for name, coefs in data.items():
            A = coefs.as_array() if hasattr(coefs, "as_array") \
                else np.asarray(coefs)
            T = A.shape[0]
            flat = A.reshape(T, -1).astype(np.float64)
            if keys and name in keys:
                sel = [np.ravel_multi_index(k, A.shape[1:]) for k in keys[name]]
            else:
                varying = np.nonzero(flat.var(axis=0) > 0)[0]
                if varying.size > 500:
                    import warnings

                    warnings.warn(
                        f"Koopman: dataset {name!r} has {varying.size} "
                        f"varying channels; auto-selection keeps the "
                        f"first 500 — pass keys= to choose explicitly",
                        stacklevel=3)
                sel = list(varying[:500])
            for j in sel:
                cols.append(flat[:, j])
                self.keys.append((name, j))
            if not hasattr(self, "_shapes"):
                self._shapes = {}
            self._shapes[name] = A.shape[1:]
            self._shape = A.shape[1:]     # single-name convenience
        D = np.stack(cols, axis=0)            # (C, T)
        self.T = D.shape[1]                   # original series length
        self._mean = D.mean(axis=1, keepdims=True)
        D = D - self._mean
        if self.window > 1:
            w = self.window
            T = D.shape[1]
            D = np.concatenate([D[:, j:T - w + 1 + j] for j in range(w)],
                               axis=0)        # (C*w, T-w+1)
        self.D = D
        self.nchan = len(self.keys)
        self._decompose()

    def _decompose(self):
        X0 = self.D[:, :-1]
        X1 = self.D[:, 1:]
        U, S, Vt = np.linalg.svd(X0, full_matrices=False)
        r = min(self.numev, int(np.sum(S > S[0] * 1e-12)))
        U, S, Vt = U[:, :r], S[:r], Vt[:r]
        Atilde = U.T @ X1 @ Vt.T / S
        lam, W = np.linalg.eig(Atilde)
        self.ev = lam                               # Koopman eigenvalues
        self.modes = X1 @ Vt.T @ np.diag(1.0 / S) @ W   # exact DMD modes (C, r)
        # amplitudes from the initial condition
        self.amp = np.linalg.lstsq(self.modes, self.D[:, 0], rcond=None)[0]
        self.rank = r

    def eigenvalues(self):
        return self.ev.copy()

    def frequencies(self, dt=1.0):
        """Continuous-time frequencies: Im(log lambda)/dt."""
        return np.log(self.ev.astype(complex)).imag / dt

    def growth_rates(self, dt=1.0):
        return np.log(np.abs(self.ev)) / dt

    def getModes(self):
        return self.modes.copy()

    def reconstruction(self, nt=None, modes=None):
        """x(t) = Phi diag(lambda^t) b  (+mean); returns (C, nt) for the
        physical (un-delayed) channels.  Defaults to the ORIGINAL series
        length (with window > 1 the embedded matrix is w-1 samples
        shorter, but the modes evolve to any t)."""
        nt = self.T if nt is None else nt
        sel = np.arange(self.rank) if modes is None else np.asarray(modes)
        t = np.arange(nt)
        dyn = self.ev[sel][:, None] ** t[None, :]        # (r, nt)
        out = (self.modes[:, sel] * self.amp[sel]) @ dyn
        return out.real[:self.nchan] + self._mean
