"""Coefficient-noise playback (port of exp_tpu/nbody/noise.py; the
reference's NOISE experiment knob).

SphericalBasis's `NOISE: true` replaces the live expansion coefficients each
step with Gaussian draws whose per-(l, n) variance comes from the one-particle
coefficient moments of a background model (src/SphericalBasis.cc:2109-2214:
`compute_rms_coefs` quadrature + `update_noise` draw).

The moments are a one-time host quadrature over the force's radial tables;
the per-step draw is a host NumPy RNG (the reference seeds the SAME
generator on every rank and draws host-side too), delivered through the
driver's playback channel.  With the same seed the draws are exp_tpu's
numbers.

Transcription notes (kept verbatim for parity, documented because they are
surprising): the reference subtracts `meanC[n]^2` from `rmsC(l, n)` for EVERY
l even though meanC is the l=0 moment, scales the variance by the Ylm
normalization factor `factorial(l, m)` LINEARLY inside the sqrt, and adds the
un-normalized `meanC` to the l=0 cosine coefficients (update_noise,
SphericalBasis.cc:2190-2208).
"""

from __future__ import annotations

import numpy as np
import torch


class SphereNoise:
    """Per-step noise coefficients for a spherical BFE force.

    Exposes the playback interface (`interpolate(t)` returning the force's
    (2, lmax+1, lmax+1, nmax) coefficient array), so a component with NOISE
    configured simply uses this object as its playback source.  Each call
    draws fresh noise (the reference re-draws on every determine_coefficients
    call, SphericalBasis.cc:395).
    """

    def __init__(self, std, mean, seedN=11):
        self.std = np.asarray(std)      # (2, L+1, L+1, nmax)
        self.mean = np.asarray(mean)    # (2, L+1, L+1, nmax), l=0 cos only
        self.rng = np.random.default_rng(int(seedN))

    @classmethod
    def build(cls, force, model, noiseN=1.0e-6, seedN=11, numg=100):
        """Compute the moment tables from `model` against `force`'s basis.

        Mirrors compute_rms_coefs (SphericalBasis.cc:2109-2148): 100-point
        Gauss-Legendre over the model's radial span of the one-particle
        coefficient moments
            meanC[n]    = int dr r^2 4 pi rho(r) u_{0n}(r/scale)/scale
            rmsC[l, n]  = int dr r^2 4 pi rho(r) (u_{ln}(r/scale)/scale)^2
        with u the same normalized radial table the coefficient kernel uses
        (potd/sqnorm in the reference), then the draw scale
            std(l, m, n) = sqrt(|rmsC - meanC^2| * fac[l, m] / noiseN)
        (update_noise, SphericalBasis.cc:2190-2208).
        """
        grid = force.grid
        scale = float(force.scale)
        lmax, nmax = force.lmax, force.nmax
        rmin = float(model.rmin)
        rmax = float(model.rmax)
        kn, wt = np.polynomial.legendre.leggauss(int(numg))
        kn = 0.5 * (kn + 1.0)           # LegeQuad convention: knots on (0,1)
        wt = 0.5 * wt
        dr = rmax - rmin
        r = rmin + dr * kn
        rt = torch.as_tensor(np.asarray(r / scale, np.float64),
                             device=grid.pot_t.device)
        u = grid.get_pot(rt).detach().cpu().numpy().astype(np.float64)
        pot = u / scale                                    # (numg, L+1, nmax)
        rho = np.asarray([model.get_density(ri) for ri in r], np.float64)
        wgt = dr * wt * r * r * 4.0 * np.pi * rho          # (numg,)
        meanC = np.einsum("i,in->n", wgt, pot[:, 0, :])
        rmsC = np.einsum("i,iln->ln", wgt, pot ** 2)

        var = np.abs(rmsC - meanC[None, :] ** 2)           # (L+1, nmax)
        fac = force.fac.detach().cpu().numpy().astype(np.float64)
        std = np.sqrt(var[:, None, :] * fac[:, :, None] / float(noiseN))
        std = np.broadcast_to(std[None], (2,) + std.shape).copy()
        ls = np.arange(lmax + 1)
        std[:, ls[:, None] < ls[None, :], :] = 0.0         # m > l
        std[1, :, 0, :] = 0.0                              # sin m=0
        mean = np.zeros_like(std)
        mean[0, 0, 0, :] = meanC
        obj = cls(std, mean, seedN=seedN)
        obj.meanC, obj.rmsC = meanC, rmsC                  # diagnostics
        return obj

    def interpolate(self, t):
        """Fresh noise draw (playback interface; `t` is unused — the
        reference redraws per call, not per time)."""
        return (self.std * self.rng.standard_normal(self.std.shape)
                + self.mean).astype(np.float32)

    # playback sources are also asked for their time span in some paths;
    # noise is valid for all times
    def times(self):
        return [0.0]
