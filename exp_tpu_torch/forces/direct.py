"""Direct O(N^2) softened summation (port of exp_tpu/forces/direct.py; the
reference's `direct` force, src/Direct.H/.cc, src/GravKernel.H/.cc), on
one device.

The `coefficients` protocol returns the sources themselves, (x, mass), so
the force plugs into the same step machinery as the basis forces; the
driver and the multistep runner hand a source component's positions and
masses to `acceleration`.

Source models (src/Direct.cc:250-340):
  * kernel='plummer' — Plummer softening (GravKernel.cc PlummerSoft);
  * kernel='spline'  — compact-support cubic-spline softening
    (GravKernel.cc SplineSoft; the reference's default), exact 1/r
    outside r = eps;
  * mn_model         — every source is a Miyamoto-Nagai disk of scale
    (a, b) (Direct.cc:264-300);
  * pm_model         — every source carries a normalized extended
    spherical profile (SphericalModelTable; Direct.cc:310-318): inside
    the model's rmax the enclosed-mass fraction replaces the kernel.
    (The reference adds the model potential UNSCALED by the source
    mass; here pot is mass * model_pot / M(rmax), as in exp_tpu.)

The pair sum runs in plain PyTorch (exp_tpu's is no Pallas kernel).  It
chunks the sources as exp_tpu does — chunks of `chunk` when the source
count is a multiple of it and larger, else all at once — and adds each
chunk's sum to a target's running total in source order.  It also chunks
the targets, so that the (targets, sources) temporaries of one chunk pair
stay under `tmp_bytes`.

Over the ranks of a World (`group`), the sum is exp_tpu's ring (its
ppermute over `axis_name`; Direct.H): rank r adds, at pass i, the force of
the source block of rank (r - i) mod size.  The blocks reach every rank
once, by one all-reduce of a zero-padded buffer (the port's gather, which
runs on every backend), and are then summed in the ring's order; ranks may
hold blocks of different sizes.
"""

from __future__ import annotations

import torch
from torch import nn

from exp_tpu_torch.ops.interp import interp

#: elements of the pair temporaries a (target, source) pair holds at once:
#: the displacement (3), its pair terms (up to 10 scalars) and the
#: acceleration (3)
_PAIR_ELEMS = 16


def _spline_mfrac_pot(r, rinv, eps):
    """SplineSoft (GravKernel.cc:14-31): enclosed mass fraction and
    potential-per-unit-mass for the cubic-spline density kernel.
    Branchless over the three x = r/eps regimes."""
    def m1(x):
        return 32. * x**3 * (1. / 3. - 6. / 5. * x * x + x**3)

    def m2(x):
        return 16. / 15. * x**3 * (20. - 45. * x + 36. * x * x
                                   - 10. * x**3)

    def p1(x):
        return 32. * x * x * (0.5 - 1.5 * x * x + 6. / 5. * x**3)

    def p2(x):
        return 32. * x * x * (1. - 2. * x + 1.5 * x * x - 2. / 5. * x**3)

    fac0 = m1(0.5) - m2(0.5)
    fac1 = p2(1.0) - p2(0.5) + p1(0.5)
    fac2 = p2(1.0)
    x = r / eps
    xc = torch.clamp(x, max=1.0)
    mfrac = torch.where(x < 0.5, m1(xc),
                        torch.where(x < 1.0, fac0 + m2(xc), 1.0))
    # pot/unit mass: inner = -(fac1 - p1)/eps - mfrac/r;
    # mid = -mfrac/r - (fac2 - p2)/eps; outer = -1/r
    pot = torch.where(
        x < 0.5, -(fac1 - p1(xc)) / eps - mfrac * rinv,
        torch.where(x < 1.0, -mfrac * rinv - (fac2 - p2(xc)) / eps, -rinv))
    return mfrac, pot


class DirectForce(nn.Module):
    """All-pairs softened gravity of a source component; the pm-model
    tables (r, M, Phi) are f32 buffers, as exp_tpu stores them."""

    #: the driver hands this force its component's (x, mass) as sources
    needs_sources = True
    #: the cap on one chunk pair's temporaries
    tmp_bytes = 1 << 30

    def __init__(self, eps: float = 1e-4, chunk: int = 16384,
                 kernel: str = "plummer", mn_model: bool = False,
                 a: float = 1.0, b: float = 0.1, pm_r=None, pm_mass=None,
                 pm_pot=None, lmax: int = 0, nmax: int = 1,
                 scale: float = 1.0):
        super().__init__()
        self.eps, self.chunk, self.kernel = float(eps), int(chunk), kernel
        self.mn_model, self.a, self.b = bool(mn_model), float(a), float(b)
        self.register_buffer("pm_r", pm_r)
        self.register_buffer("pm_mass", pm_mass)
        self.register_buffer("pm_pot", pm_pot)
        self.lmax, self.nmax, self.scale = int(lmax), int(nmax), float(scale)

    @classmethod
    def with_pm_model(cls, model, device="cpu", **kw):
        """Extended point-mass profile from a SphericalModelTable."""
        def f32(a):
            return torch.as_tensor(a, dtype=torch.float32, device=device)

        return cls(pm_r=f32(model.r), pm_mass=f32(model.mass),
                   pm_pot=f32(model.pot), **kw)

    @property
    def coef_shape(self):
        return None

    def coefficients(self, x, mass, accum_dtype=torch.float32):
        """The 'coefficients' of the direct force are this rank's sources
        (the ring in `acceleration` brings the other ranks')."""
        return (x, mass)

    def _pair_mn(self, d, ms):
        """Miyamoto-Nagai source profile (Direct.cc:264-300); `d` is the
        target-minus-source displacement."""
        R2 = d[..., 0] ** 2 + d[..., 1] ** 2
        zb = torch.sqrt(d[..., 2] ** 2 + self.b * self.b)
        ab = self.a + zb
        dn2 = R2 + ab * ab
        dninv = torch.rsqrt(dn2)
        live = (ms > 0.0) & (R2 + d[..., 2] ** 2 > 0.0)  # skip self-pairs
        m_eff = torch.where(live, ms, 0.0)
        pot = -m_eff * dninv
        fr_over_R = -m_eff * dninv * dninv * dninv       # f_R / R
        fz = fr_over_R * d[..., 2] * ab / zb             # -m z ab/(zb dn^3)
        acc = torch.stack([fr_over_R * d[..., 0], fr_over_R * d[..., 1], fz],
                          dim=-1)
        return acc, pot

    def _pair_spherical(self, d, ms):
        """Softened spherical sources: plummer/spline kernel, optionally
        replaced by the normalized extended profile inside its rmax."""
        eps = self.eps
        r2raw = torch.sum(d * d, dim=-1)
        live = (ms > 0.0) & (r2raw > 0.0)    # skip self-pairs (i == j)
        m_eff = torch.where(live, ms, 0.0)
        if self.kernel == "spline":
            r = torch.sqrt(torch.clamp(r2raw, min=1e-30))
            rinv = 1.0 / r
            mfrac, potk = _spline_mfrac_pot(r, rinv, eps)
            mr3 = m_eff * mfrac * rinv * rinv * rinv
            pot = m_eff * potk
        else:
            r2 = r2raw + eps * eps
            rinv = torch.rsqrt(r2)
            r = torch.sqrt(torch.clamp(r2raw, min=1e-30))
            mr = m_eff * rinv
            mr3 = mr * rinv * rinv
            pot = -mr
        if self.pm_r is not None:
            rmax = self.pm_r[-1]
            Mmax = self.pm_mass[-1]
            inside = r < rmax
            mfrac_pm = interp(r, self.pm_r, self.pm_mass) / Mmax
            pot_pm = m_eff * interp(r, self.pm_r, self.pm_pot) / Mmax
            mr3 = torch.where(inside, m_eff * mfrac_pm / (r * r * r), mr3)
            pot = torch.where(inside, pot_pm, pot)
        return mr3[..., None] * d, pot

    def _pairs(self, xs, ms, x):
        """Summed force of sources (xs, ms) on targets x, one chunk pair."""
        d = xs[None, :, :] - x[:, None, :]               # (Nt, C, 3)
        if self.mn_model:
            # MN fields take the target-minus-source displacement
            a_c, p_c = self._pair_mn(-d, ms[None, :])
        else:
            a_c, p_c = self._pair_spherical(d, ms[None, :])
        return torch.sum(a_c, dim=1), torch.sum(p_c, dim=1)

    def target_chunk(self, n_src, dtype):
        """Targets a chunk: as many as keep the pair temporaries of one
        source chunk under tmp_bytes."""
        ch = min(self.chunk, n_src)
        if not (n_src % ch == 0 and n_src > ch):
            ch = n_src
        per_target = max(ch, 1) * _PAIR_ELEMS * torch.finfo(dtype).bits // 8
        return max(1, self.tmp_bytes // per_target)

    def _partial(self, xs, ms, x):
        """Force of sources (xs, ms) on targets x: targets in chunks, and
        within each the sources chunked as exp_tpu chunks them, each
        chunk's sum added in turn."""
        n = xs.shape[0]
        ch = min(self.chunk, n)
        if n % ch == 0 and n > ch:
            src = list(zip(xs.split(ch), ms.split(ch)))
        else:
            src = [(xs, ms)]
        nt = self.target_chunk(n, x.dtype)
        accs, pots = [], []
        for xt in x.split(nt):
            acc = torch.zeros_like(xt)
            pot = torch.zeros(xt.shape[0], dtype=xt.dtype, device=xt.device)
            for xs_c, ms_c in src:
                a_c, p_c = self._pairs(xs_c, ms_c, xt)
                acc = acc + a_c
                pot = pot + p_c
            accs.append(acc)
            pots.append(pot)
        return torch.cat(accs), torch.cat(pots)

    def acceleration(self, coef, x, group=None):
        """Force of the sources `coef` = (xs, ms) on targets x; with a
        World of several ranks, of every rank's sources, in ring order."""
        xs, ms = coef
        if group is None or group.size == 1:
            return self._partial(xs, ms, x)
        from exp_tpu_torch.parallel.distributed import allgather_rows

        src, lens = allgather_rows(torch.cat([xs, ms[:, None]], dim=1),
                                   group)
        offs = [sum(lens[:k]) for k in range(group.size)]
        acc = torch.zeros_like(x)
        pot = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for i in range(group.size):
            k = (group.rank - i) % group.size
            blk = src[offs[k]:offs[k] + lens[k]]
            a, p = self._partial(blk[:, :3], blk[:, 3], x)
            acc = acc + a
            pot = pot + p
        return acc, pot

    def density(self, coef, x):
        return torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
