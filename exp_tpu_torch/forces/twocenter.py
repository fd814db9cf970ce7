"""Two-center expansion (port of exp_tpu/forces/twocenter.py; the
reference's TwoCenter + MixtureBasis + EJcom, src/TwoCenter.H:15-140,
src/MixtureBasis.H, src/EJcom.cc): two sub-expansions about different
centers — the INNER center is the component's tracked (EJ/centerfile)
center, the OUTER its instantaneous COM (TwoCenter.cc:106-155) — blended
by the EJcom erf mixture

    m(x) = erf( cfac * (|x - c1|^2 / (|c2 - c1|^2 + eps))^(alpha/2) )

(EJcom.cc:42-56): the inner basis accumulates with weight 1-m (unity near
the inner center), the outer with weight m; forces are the sum of both
fields.  The sub-bases may be different force types or resolutions.

The coefficients are a pair (inner set, outer set).  The driver and the
multistep runner set the centers every step by `with_centers`, which
returns a new force on the same sub-forces.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch


@dataclass
class TwoCenterForce:
    inner: object           # any coefficient-based force (e.g. SphereSL)
    outer: object
    c1: torch.Tensor        # (3,) inner (EJ/tracked) center
    c2: torch.Tensor        # (3,) outer (COM) center
    cfac: float = 1.0
    alpha: float = 1.0
    scale: float = 1.0

    #: the driver sets c1/c2 from the tracked center and the COM
    needs_centers = True

    @property
    def lmax(self):
        return self.inner.lmax

    @property
    def nmax(self):
        return self.inner.nmax

    def with_centers(self, c1, c2):
        return replace(self, c1=c1, c2=c2)

    @property
    def coef_shape(self):
        return (self.inner.coef_shape, self.outer.coef_shape)

    def mixture(self, x):
        """EJcom erf ramp, in [0, 1): ~0 near the inner center."""
        d1 = torch.sum((x - self.c1) ** 2, dim=-1)
        d12 = torch.sum((self.c2 - self.c1) ** 2)
        arg = self.cfac * torch.pow(d1 / (d12 + 1e-10), 0.5 * self.alpha)
        return torch.special.erf(arg)

    def coefficients(self, x, mass, accum_dtype=torch.float32):
        m = self.mixture(x)
        return (self.inner.coefficients(x - self.c1, mass * (1 - m),
                                        accum_dtype=accum_dtype),
                self.outer.coefficients(x - self.c2, mass * m,
                                        accum_dtype=accum_dtype))

    def acceleration(self, coef, x):
        a1, p1 = self.inner.acceleration(coef[0], x - self.c1)
        a2, p2 = self.outer.acceleration(coef[1], x - self.c2)
        return a1 + a2, p1 + p2

    def density(self, coef, x):
        return (self.inner.density(coef[0], x - self.c1)
                + self.outer.density(coef[1], x - self.c2))
