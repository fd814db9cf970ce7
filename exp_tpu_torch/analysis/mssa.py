"""Multivariate singular spectrum analysis (pyEXP `mssa` submodule).

A host-side NumPy copy of exp_tpu/analysis/mssa.py (the port imports
nothing of exp_tpu).

The analogue of expui/expMSSA (expMSSA.H:13-220, expMSSA.cc): MSSA over
selected coefficient channels — trajectory (Hankel) matrix, SVD of the
trajectory matrix (same convention as the reference's RedSVD usage,
expMSSA.cc:4-8), eigentriple grouping, w-correlation, and reconstruction of
selected groups back into coefficient series by anti-diagonal averaging.

Channels: for 'sphere' geometry a channel key is (cs, l, m, n) into the
(2, lmax+1, lmax+1, nmax) array; any flat index tuple works for other
geometries.  NumPy/SciPy host math (series are small: T x channels).
"""

from __future__ import annotations

import numpy as np


class expMSSA:
    """MSSA over coefficient time series.

    Args:
      data: dict name -> analysis.coefs.Coefs (or (T, ...) arrays).
      window: embedding window length w.
      numpc: number of components to keep.
      keys: dict name -> list of channel index tuples (default: all channels
            with nonzero variance, capped at 500).
    """

    def __init__(self, data: dict, window: int, numpc: int, keys=None,
                 flip_sign: bool = True):
        self.window = int(window)
        self.numpc = int(numpc)
        self.flip_sign = bool(flip_sign)
        self._series = {}       # (name, key) -> (T,) detrended series
        self._mean = {}
        self.names = list(data)

        for name, coefs in data.items():
            A = coefs.as_array() if hasattr(coefs, "as_array") \
                else np.asarray(coefs)
            T = A.shape[0]
            flat = A.reshape(T, -1)
            if keys and name in keys:
                sel = [np.ravel_multi_index(k, A.shape[1:]) for k in keys[name]]
            else:
                var = flat.var(axis=0)
                sel = list(np.nonzero(var > 0)[0][:500])
            for j in sel:
                s = flat[:, j].astype(np.float64)
                mu = s.mean()
                self._series[(name, j)] = s - mu
                self._mean[(name, j)] = mu
            if not hasattr(self, "_shapes"):
                self._shapes = {}
            self._shapes[name] = A.shape[1:]
            self._shape = A.shape[1:]     # single-name convenience
            self._T = T

        self.keys = list(self._series)
        self.nkeys = len(self.keys)
        if self.window >= self._T:
            raise ValueError("window must be < number of snapshots")
        self._decompose()

    # ------------------------------------------------------------------

    def _decompose(self):
        w = self.window
        K = self._T - w + 1
        C = self.nkeys
        X = np.empty((K, w * C))
        for c, key in enumerate(self.keys):
            s = self._series[key]
            for j in range(w):
                X[:, c * w + j] = s[j:j + K]
        self._X = X
        # SVD of the trajectory matrix (not the covariance), like RedSVD
        U, S, Vt = np.linalg.svd(X, full_matrices=False)
        k = min(self.numpc, S.size)
        self.S = S[:k]
        self.U = U[:, :k]           # (K, k) left vectors
        self.Vt = Vt[:k]            # (k, wC) right vectors
        if self.flip_sign:
            # deterministic per-triple sign: the largest-|PC| sample is
            # positive (U and Vt flip together, so reconstructions are
            # unchanged; only the displayed PC/EOF signs are)
            for j in range(k):
                if self.U[np.argmax(np.abs(self.U[:, j])), j] < 0:
                    self.U[:, j] = -self.U[:, j]
                    self.Vt[j] = -self.Vt[j]
        self.PC = self.U * self.S   # principal components (K, k)
        self._recon = None

    # -- diagnostics ---------------------------------------------------------

    def eigenvalues(self):
        return self.S ** 2

    def singular_values(self):
        return self.S.copy()

    def contributions(self):
        lam = self.S ** 2
        return lam / lam.sum() if lam.sum() > 0 else lam

    def pcs(self):
        return self.PC.copy()

    # ------------------------------------------------------------------

    def _elementary(self, comp, key_index):
        """Reconstructed series of one eigentriple for one channel
        (anti-diagonal averaging of the rank-1 trajectory block)."""
        w = self.window
        K = self._T - w + 1
        block = np.outer(self.PC[:, comp],
                         self.Vt[comp, key_index * w:(key_index + 1) * w])
        out = np.zeros(self._T)
        cnt = np.zeros(self._T)
        for j in range(w):
            out[j:j + K] += block[:, j]
            cnt[j:j + K] += 1.0
        return out / cnt

    def reconstructed(self, groups=None):
        """Sum the selected eigentriples back to per-channel series.

        groups: list of component indices, or a list of index groups
        (e.g. straight from auto_group/kmeans) — nested lists are
        flattened (default: all kept).
        Returns dict (name, flat_index) -> (T,) series including the mean.
        """
        if groups is None:
            comps = list(range(self.S.size))
        else:
            comps = []
            for g in groups:
                comps.extend(g if hasattr(g, "__len__") else [g])
        out = {}
        for ci, key in enumerate(self.keys):
            s = np.zeros(self._T)
            for c in comps:
                s += self._elementary(c, ci)
            out[key] = s + self._mean[key]
        self._recon = out
        return out

    def reconstruct_coefs(self, coefs, groups=None, name=None):
        """Write a reconstruction into a copy of a Coefs container
        (expMSSA::reconstruct + getReconstructed, expMSSA.H:135-220).

        `name` restricts to that dataset's channels — REQUIRED for
        multi-name configs, where channel indices are per-dataset."""
        if name is None and len(self.names) > 1:
            raise ValueError(
                "reconstruct_coefs: name= is required with multiple "
                f"datasets {self.names} (channel indices are per-dataset)")
        rec = self.reconstructed(groups)
        out = coefs.deepcopy()
        times = out.times()
        A = out.as_array()
        flat = A.reshape(A.shape[0], -1)
        for (nm, j), series in rec.items():
            if name is not None and nm != name:
                continue
            flat[:, j] = series
        shape = self._shapes[name] if name is not None else self._shape
        for i, t in enumerate(times):
            out._data[t] = flat[i].reshape(shape)
        return out

    # -- Koopman/eDMD over the embedded channel space ----------------------

    def koopman_modes(self, tol=1e-12):
        """eDMD on the delay-embedded snapshot sequence
        (expMSSA::getKoopmanModes, expMSSA.cc:1720-1860: the trajectory
        matrix rows advance one sample per row, so DMD of X[:-1] -> X[1:]
        truncated at s > tol*s_max estimates the Koopman operator on the
        embedded channel space).

        Returns (eigenvalues (r,) complex, modes (w*C, r) complex);
        amplitudes for reconstruction are stored."""
        X = self._X                              # (K, wC)
        Y1, Y2 = X[:-1].T, X[1:].T               # (wC, K-1) snapshot cols
        U, S, Vt = np.linalg.svd(Y1, full_matrices=False)
        r = max(1, int(np.sum(S > tol * max(S[0], 1e-300))))
        U, S, Vt = U[:, :r], S[:r], Vt[:r]
        Atil = (U.T @ Y2 @ Vt.T) / S[None, :]
        evals, W = np.linalg.eig(Atil)
        Phi = (Y2 @ Vt.T / S[None, :]) @ W       # exact DMD modes (wC, r)
        b = np.linalg.lstsq(Phi, Y1[:, 0], rcond=None)[0]
        self._koopman = (evals, Phi, b)
        return evals, Phi

    def koopman_series(self, mode):
        """Per-channel series of ONE Koopman mode: rank-1 dynamics
        Re(b_m lambda_m^t phi_m) anti-diagonally averaged back from the
        delay embedding (the real part halves a complex-conjugate pair —
        sum the pair's modes for the full oscillation)."""
        if not hasattr(self, "_koopman"):
            self.koopman_modes()
        evals, Phi, b = self._koopman
        K = self._X.shape[0]
        dyn = b[mode] * evals[mode] ** np.arange(K)
        block = np.real(np.outer(dyn, Phi[:, mode]))     # (K, wC)
        w = self.window
        out = {}
        for c, key in enumerate(self.keys):
            s = np.zeros(self._T)
            cnt = np.zeros(self._T)
            blk = block[:, c * w:(c + 1) * w]
            for j in range(w):
                s[j:j + K] += blk[:, j]
                cnt[j:j + K] += 1.0
            out[key] = s / cnt
        return out

    def reconstruct_koopman(self, coefs, mode, name=None):
        """Write one Koopman mode's reconstruction (plus the channel means)
        into a copy of a Coefs container (expMSSA::getReconstructedKoopman)."""
        rec = self.koopman_series(mode)
        out = coefs.deepcopy()
        times = out.times()
        A = out.as_array()
        flat = A.reshape(A.shape[0], -1)
        for (nm, j), series in rec.items():
            if name is not None and nm != name:
                continue
            flat[:, j] = series + self._mean[(nm, j)]
        shape = self._shapes[name] if name is not None else self._shape
        for i, t in enumerate(times):
            out._data[t] = flat[i].reshape(shape)
        return out

    def wcorr(self, ncomp=None, channels=None):
        """w-correlation matrix between elementary reconstructions
        (expMSSA w-correlation diagnostics).

        channels: optional list of channel positions (indices into
        self.keys) to restrict the elementary series to — per-channel /
        per-dataset w-correlation; default sums over all channels."""
        k = self.S.size if ncomp is None else min(ncomp, self.S.size)
        w = self.window
        T = self._T
        # weights: how often each time index appears in the Hankel matrix
        wt = np.minimum(np.minimum(np.arange(1, T + 1), w),
                        np.minimum(T - np.arange(T), T - w + 1)).astype(float)
        chans = range(self.nkeys) if channels is None else channels
        series = np.zeros((k, T))
        for c in range(k):
            for ci in chans:
                series[c] += self._elementary(c, ci)
        W = np.zeros((k, k))
        for a in range(k):
            for b in range(k):
                W[a, b] = np.sum(wt * series[a] * series[b])
        d = np.sqrt(np.diag(W))
        d[d == 0] = 1.0
        return W / np.outer(d, d)

    # ------------------------------------------------------------------
    # DFT diagnostics (expMSSA::pcDFT/channelDFT/singleDFT,
    # expui/expMSSA.cc:805-1030)
    # ------------------------------------------------------------------

    def _dt(self):
        return 1.0

    def pcDFT(self, dt=1.0):
        """Frequency grid + power spectrum of each PC column.

        Returns (freq (nfreq,), power (nfreq, npc))."""
        K = self.PC.shape[0]
        freq = 2.0 * np.pi * np.fft.rfftfreq(K, d=dt)
        P = np.abs(np.fft.rfft(self.PC, axis=0)) ** 2 / K
        return freq, P

    def channelDFT(self, dt=1.0, groups=None):
        """Power spectrum of the (group-)reconstructed channel series.

        Returns (freq, dict (name, flat_index) -> (nfreq,) power)."""
        rec = self.reconstructed(groups)
        T = self._T
        freq = 2.0 * np.pi * np.fft.rfftfreq(T, d=dt)
        out = {}
        for key, series in rec.items():
            s = series - series.mean()
            out[key] = np.abs(np.fft.rfft(s)) ** 2 / T
        return freq, out

    def singleDFT(self, key, dt=1.0):
        """Per-PC power spectra for one channel: (freq, (nfreq, ncomp))."""
        ki = self.keys.index(key)
        T = self._T
        freq = 2.0 * np.pi * np.fft.rfftfreq(T, d=dt)
        P = np.zeros((freq.size, self.S.size))
        for c in range(self.S.size):
            e = self._elementary(c, ki)
            P[:, c] = np.abs(np.fft.rfft(e - e.mean())) ** 2 / T
        return freq, P

    # ------------------------------------------------------------------
    # Eigentriple grouping: KMeans with the w-correlation distance
    # (expMSSA::kmeans/kmeansChannel, expui/KMeans.cc WcorrDistance:
    # d(x, y) = 1 - sqrt(wcorr(x, y))) and w-correlation auto-grouping
    # ------------------------------------------------------------------

    def _wcorr_weights(self):
        w, T = self.window, self._T
        return np.minimum(np.minimum(np.arange(1, T + 1), w),
                          np.minimum(T - np.arange(T), T - w + 1)
                          ).astype(float)

    def _wcorr_dist(self, x, y, wt):
        corr = np.sum(wt * x * y)
        nx = np.sum(wt * x * x)
        ny = np.sum(wt * y * y)
        if nx * ny <= 0:
            return 1.0
        return 1.0 - np.sqrt(max(corr / np.sqrt(nx * ny), 0.0))

    def _kmeans_points(self, key=None):
        """Per-eigentriple series: one channel's elementaries, or summed
        over channels when key is None (expMSSA::kmeans pack)."""
        k = self.S.size
        pts = np.zeros((k, self._T))
        if key is not None:
            ki = self.keys.index(key)
            for c in range(k):
                pts[c] = self._elementary(c, ki)
        else:
            for c in range(k):
                for ci in range(self.nkeys):
                    pts[c] += self._elementary(c, ci)
        return pts

    def kmeans(self, clusters, stride=1, key=None, iters=100, seed=0):
        """Cluster eigentriples by w-correlation distance.

        Returns (ids (k,), dists (k,), tol) — cluster id and distance to
        the assigned center per eigentriple (kmeansChannel when `key` is
        given, else all channels summed)."""
        pts = self._kmeans_points(key)
        k = pts.shape[0]
        clusters = min(int(clusters), k)
        wt = self._wcorr_weights()
        if stride and stride > 0:
            seeds = list(range(0, k, max(1, stride)))[:clusters]
        else:
            rng = np.random.default_rng(seed)
            seeds = list(rng.choice(k, size=clusters, replace=False))
        centers = pts[seeds].copy()
        ids = np.zeros(k, dtype=int)
        tol = np.inf
        for _ in range(iters):
            d = np.array([[self._wcorr_dist(p, c, wt) for c in centers]
                          for p in pts])
            new_ids = d.argmin(axis=1)
            new_centers = np.array([
                pts[new_ids == j].mean(axis=0) if (new_ids == j).any()
                else centers[j] for j in range(clusters)])
            tol = float(np.abs(new_centers - centers).max())
            centers = new_centers
            if (new_ids == ids).all() and tol < 1e-10:
                ids = new_ids
                break
            ids = new_ids
        dists = np.array([np.sqrt(((pts[j] - centers[ids[j]]) ** 2).sum())
                          for j in range(k)])
        return ids, dists, tol

    def auto_group(self, threshold=0.5, ncomp=None):
        """w-correlation auto-grouping: connected components of the
        eigentriple graph with edges wcorr(a, b) > threshold.  Returns a
        list of index groups, ordered by total variance."""
        W = np.abs(self.wcorr(ncomp))
        k = W.shape[0]
        seen = np.zeros(k, bool)
        groups = []
        for s in range(k):
            if seen[s]:
                continue
            stack = [s]
            grp = []
            seen[s] = True
            while stack:
                a = stack.pop()
                grp.append(a)
                for b in range(k):
                    if not seen[b] and W[a, b] > threshold:
                        seen[b] = True
                        stack.append(b)
            groups.append(sorted(grp))
        groups.sort(key=lambda g: -sum(self.S[i] for i in g))
        return groups
