"""Binary multistep (block-timestep) KDK integrator on one device (port of
exp_tpu/nbody/multistep.py).

* Levels 0..M; level l steps with dt_l = dtime/2^l; one big step = 2^M fine
  substeps; level l is active at substeps ms with ms % 2^(M-l) == 0, so the
  active set is always the suffix [mfirst(ms), M] (multistep.cc:630-679).
* Particles live in per-level buckets padded to capacities that change
  only when a level outgrows its bucket, so a substep works on the active
  buckets only.
* Coefficient tableau: per-level registers (L, N).  When level l activates
  it drifts a full dt_l and its pair advances (L <- N, N <- new); the full
  coefficient set at substep position mdrft is sum_l lerp(L_l, N_l, w_l)
  with w_l = ((ms mod 2^(M-l)) + 1)/2^(M-l), summed in the JAX package's
  order so that f64 runs agree to rounding.
* Levels come from the reference's timestep criteria (multistep.cc:94-130)
  at big-step boundaries, where all levels are synchronised (the
  reference's NoSwitch discipline).

The runner is eager: a big step is a host loop over the 2^M substeps, each
launching the force kernels on the active buckets; `fused=True` runs the
same loop (the card's counterpart of the JAX package's one-jit big step, a
CUDA graph, is performance work: ROADMAP's perf_opt item 9b.1).  Buckets are updated in place, like the
port's KDK step.  A relevel reads the level counts, the number of live
particles that changed level and the overrun counts on the host, once; when
no particle changed level it returns the state and registers as they are,
with no rebucket and no register rebuild.  The rebucket is one stable sort
of the level key (dead rows last), one row gather of the 12 float columns
packed together and a separate int32 gather of `indx`, whichever of the
JAX package's 'sortfull' and 'sortgather' is asked for: on the card a
gather costs what the sort's payload would, so one engine serves both.

Two-center forces and source-based (direct) forces run as in exp_tpu's
substep: a two-center force is rebuilt each substep with the component's
resolved center as its inner center and its COM over all buckets as its
outer one, and projects the raw positions (it subtracts its centers
itself); its coefficients are a pair, which `tmap` carries through the
registers and the assembly.  A source component has no registers: every
kick reads the positions and masses of all its buckets, the inactive ones
at their frozen positions, as the reference's per-level force pass does.

The driver's extras follow exp_tpu's substep: position wrappers
(PeriodicBC) after each drift; external fields evaluated at the substep's
drift time in every kick; and, from `extras_fn(t)` called once a substep
at its drift time, playback coefficients (which replace a component's
assembled set, its registers unused), Hall weights on the assembled set,
then the restriction's `c * mask + offset`, and the non-inertial frame
correction (`pseudo`), subtracted once a kick.

Not ported, each raising NotImplementedError with its ROADMAP item: the
'incremental' rebucket (item 9b.2) and the multi-device all-reduce (item
12).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from exp_tpu_torch.nbody.particles import ParticleSystem
from exp_tpu_torch.nbody.step import _diagnostics

REBUCKET_STYLES = ("sortfull", "sortgather")


def mintvl_table(M: int) -> list[int]:
    return [2 ** (M - l) for l in range(M + 1)]


def mfirst_of(ms: int, M: int) -> int:
    """Smallest active level at substep ms (multistep.cc mfirst)."""
    for l in range(M + 1):
        if ms % (2 ** (M - l)) == 0:
            return l
    return M


@dataclass(frozen=True)
class CompFeats:
    """Static per-component options the substeps honour (Component.H:
    136-163): adiabatic mass ramp, rtrunc expansion cutoff, the
    instantaneous-COM expansion frame.  `needs_sources` keeps exp_tpu's
    field; the runner reads a source (direct) force's flag from the force
    itself."""

    adiabatic: bool = False
    ton: float = 0.0
    twid: float = 1.0
    rtrunc: float = 1.0e20
    com_system: bool = False
    needs_sources: bool = False

    def adb(self, t):
        """Adiabatic mass factor in [0, 1] (Component::Adiabatic)."""
        if not self.adiabatic:
            return 1.0
        return 0.5 * (1.0 + math.tanh((t - self.ton) / self.twid))


def rotate(x, rot):
    """x @ rot.T as an explicit three-term sum: no matrix product, which
    TF32 would round on the card."""
    return (x[:, 0:1] * rot[None, :, 0] + x[:, 1:2] * rot[None, :, 1]
            + x[:, 2:3] * rot[None, :, 2])


def unrotate(a, rot):
    """a @ rot (back to the inertial frame), as a three-term sum."""
    return (a[:, 0:1] * rot[None, 0, :] + a[:, 1:2] * rot[None, 1, :]
            + a[:, 2:3] * rot[None, 2, :])


def _project(force, feat: CompFeats, x, mass, t, center, accum_dtype,
             rot=None):
    """Coefficients of one bucket with the features applied.  A center of
    None is the origin and a rot of None the identity: both are skipped,
    so no position passes through an arithmetic it does not need."""
    xc = x if center is None else x - center[None, :]
    if rot is not None:
        xc = rotate(xc, rot)
    mw = mass * feat.adb(t) if feat.adiabatic else mass
    if feat.rtrunc < 1.0e19:    # Component.H:136: no contribution outside
        mw = mw * (torch.sum(xc * xc, dim=-1) < feat.rtrunc ** 2).to(mw.dtype)
    return force.coefficients(xc, mw, accum_dtype=accum_dtype)


def _project_tc(force, feat: CompFeats, x, mass, t, center, accum_dtype):
    """Two-center projection: positions stay raw (the force subtracts its
    own centers), the adiabatic ramp and the rtrunc cutoff about the
    resolved inner center (None: the origin), as exp_tpu's single-rate
    step and runner apply them."""
    mw = mass * feat.adb(t) if feat.adiabatic else mass
    if feat.rtrunc < 1.0e19:
        xr = x if center is None else x - center[None, :]
        mw = mw * (torch.sum(xr * xr, dim=-1) < feat.rtrunc ** 2).to(mw.dtype)
    return force.coefficients(x, mw, accum_dtype=accum_dtype)


def tmap(fn, *sets):
    """fn over the leaves of coefficient sets: a tensor, or a tuple of
    them (a two-center force's pair), as exp_tpu's tree_map."""
    if isinstance(sets[0], (tuple, list)):
        return tuple(tmap(fn, *parts) for parts in zip(*sets))
    return fn(*sets)


def source_names(forces):
    """The components whose force sums over their particles as sources
    (`needs_sources`, the direct force)."""
    return {n for n, f in forces.items() if getattr(f, "needs_sources", False)}


def _eff_forces(forces, state, ctr):
    """Two-center (needs_centers) forces rebuilt with their centers: inner
    = the component's resolved center (None: the origin), outer = its
    instantaneous COM over all buckets (TwoCenter.cc:106-155).  Returns
    (forces, the two-center names)."""
    eff, tc = dict(forces), set()
    for n, f in forces.items():
        if not getattr(f, "needs_centers", False):
            continue
        tc.add(n)
        bs = state[n]
        x0 = bs[0].x
        msum = sum(torch.sum(b.mass) for b in bs)
        xsum = sum(torch.sum(b.mass[:, None] * b.x, dim=0) for b in bs)
        c1 = (torch.zeros(3, dtype=x0.dtype, device=x0.device)
              if ctr[n] is None else ctr[n].to(x0.dtype))
        eff[n] = f.with_centers(c1, xsum / msum)
    return eff, tc


def _sources_of(bs):
    """A source component's buckets as (x, mass) source arrays; inactive
    buckets contribute their frozen positions, as the reference's
    per-level force pass does."""
    return (torch.cat([b.x for b in bs]), torch.cat([b.mass for b in bs]))


def _accel_at(x, t, comp_couples, forces, coef_full, ctr, rots,
              externals=(), cast=True, tc=(), sources=None):
    """Acceleration and potential at positions x from the coupled
    components' assembled coefficients (centers and rots as in _project),
    plus the external fields at time t.  A two-center force (in `tc`)
    takes the raw positions; a source component (in `sources`, name ->
    (x, mass)) sums over its particles.  cast: the coefficients in the
    positions' dtype first, as exp_tpu's runner does (its single-rate
    driver passes them as they are)."""
    acc = pot = None
    sources = sources or {}
    for a in comp_couples:
        if a in sources:
            aa, pp = forces[a].acceleration(sources[a], x)
        elif a in tc:
            cf = (tmap(lambda c: c.to(x.dtype), coef_full[a]) if cast
                  else coef_full[a])
            aa, pp = forces[a].acceleration(cf, x)
        else:
            xa = x if ctr[a] is None else x - ctr[a][None, :]
            if rots[a] is not None:
                xa = rotate(xa, rots[a])
            cf = coef_full[a].to(x.dtype) if cast else coef_full[a]
            aa, pp = forces[a].acceleration(cf, xa)
            if rots[a] is not None:
                aa = unrotate(aa, rots[a])
        acc = aa if acc is None else acc + aa
        pot = pp if pot is None else pot + pp
    return _add_externals(acc, pot, x, t, externals)


def _add_externals(acc, pot, x, t, externals):
    for ext in externals:
        aa, pp = ext.acceleration(x, t)
        acc = acc + aa
        pot = pot + pp
    return acc, pot


def _pseudo_accel(pa, x, v, center):
    """Per-particle fictitious acceleration of the non-inertial expansion
    frame (Component::getPseudoAccel, Component.cc:4407-4425): frame
    acceleration + Coriolis + Euler + centrifugal terms from the tracked
    center/axis history.  `pa` = (accel, omega, domdt) 3-vectors.
    Positions enter relative to the expansion center (None: the origin);
    velocities are the current particle velocities."""
    acc3, om, dom = pa
    cross = torch.linalg.cross
    rel = x if center is None else x - center[None, :]
    omb = om[None, :].expand_as(v)
    out = acc3[None, :].expand_as(x)
    return out + (2.0 * cross(omb, v) + cross(dom[None, :].expand_as(rel),
                                              rel)
                  + cross(omb, cross(omb, rel)))


_NO_EXTRAS = {"playback": {}, "hall": {}, "restrict": {}, "pseudo": {}}


def _assemble_extras(n, tot, ex):
    """Hall weights, then the restriction's c * mask + offset, on a
    component's assembled coefficients (SphericalBasis.cc:1568-1600,
    1689-1694)."""
    from exp_tpu_torch.nbody.pca import apply_hall

    if n in ex["hall"]:
        tot = tmap(lambda c: apply_hall(c, ex["hall"][n]), tot)
    if n in ex["restrict"]:
        mk, off = ex["restrict"][n]
        tot = tot * mk + off
    return tot


def _com_centers(state, feats, centers):
    """Expansion center per component: the instantaneous COM over all
    buckets for `com_system` components, else the prescribed one (None:
    the origin)."""
    ctr = {}
    for n, bs in state.items():
        if feats[n].com_system:
            msum = sum(torch.sum(b.mass) for b in bs)
            xsum = sum(torch.sum(b.mass[:, None] * b.x, dim=0) for b in bs)
            ctr[n] = xsum / msum
        else:
            ctr[n] = centers.get(n)
    return ctr


def _sum_diag(bs):
    """The diagnostics of a component's buckets, summed in bucket order."""
    parts = [_diagnostics(b) for b in bs]
    return {k: sum(p[k] for p in parts) for k in parts[0]}


# ---------------------------------------------------------------------------
# Timestep criteria / level selection
# ---------------------------------------------------------------------------

def _rdiv(a: float, t):
    """a / t elementwise by IEEE division, as JAX divides (PyTorch takes a
    Python scalar over a tensor as a times the reciprocal)."""
    return torch.div(torch.full((), a, dtype=t.dtype, device=t.device), t)


def dtreq_fn(ps: ParticleSystem, dynfracV=0.01, dynfracA=0.03, dynfracP=0.05,
             dynfracD=1.0e32, dynfracS=1.0):
    """Per-particle requested timestep (multistep.cc:94-130).

    dts = dynfracS * scale / |v| uses the per-particle size scale; scale
    <= 0 disables that criterion for the particle (multistep.cc:110-112)."""
    eps = 1.0e-10
    vtot = torch.sum(ps.v * ps.v, dim=-1)
    atot = torch.sum(ps.acc * ps.acc, dim=-1)
    dtr = torch.abs(torch.sum(ps.v * ps.acc, dim=-1))
    ptot = torch.abs(ps.pot)

    dtd = _rdiv(dynfracD, torch.sqrt(vtot + eps))
    dtv = dynfracV * torch.sqrt(vtot / (atot + eps))
    dta = dynfracA * ptot / (dtr + eps)
    dtA = dynfracP * torch.sqrt(ptot / (atot + eps))
    dts = torch.where(ps.scale > 0,
                      dynfracS * ps.scale / (torch.sqrt(vtot) + eps),
                      torch.full_like(vtot, 1.0 / eps))

    dt = torch.minimum(torch.minimum(torch.minimum(dtd, dtv),
                                     torch.minimum(dta, dtA)), dts)
    return torch.clamp(dt, min=eps)


def _raw_levels(dtreq, dtime: float):
    """floor(log2(dtime/dtreq)), 0 where dtreq > dtime (unclamped)."""
    nlev = torch.floor(torch.log2(torch.clamp(_rdiv(dtime, dtreq), min=1.0)))
    return torch.where(dtreq > dtime, 0, nlev.to(torch.int32))


def assign_levels(dtreq, level, dtime: float, M: int, shiftlevl: int = 0):
    """dtreq -> level, with the optional max-shift clamp
    (multistep.cc:169-190)."""
    nlev = torch.clamp(_raw_levels(dtreq, dtime), 0, M)
    if shiftlevl:
        nlev = torch.clamp(torch.minimum(torch.maximum(nlev, level - shiftlevl),
                                         level + shiftlevl), 0, M)
    return nlev.to(torch.int32)


# ---------------------------------------------------------------------------
# Bucketed state
# ---------------------------------------------------------------------------

@dataclass
class LevelBuckets:
    """Per-level padded particle buckets of one component."""

    buckets: list[ParticleSystem]       # length M+1, bucket l padded to caps[l]
    caps: tuple[int, ...]

    @property
    def n_live(self):
        return sum(int((b.mass > 0).sum()) for b in self.buckets)


def _pad_cap(n: int, quantum: int = 1, headroom: int = 1) -> int:
    """Capacity of a bucket of n live particles: headroom <= 1, the next
    power of two; headroom >= 2, (1 + 0.15 headroom) n rounded up on a
    pow2/8 grid (the JAX package's policy: the pow2/8 grid keeps the
    capacity signature sticky under sqrt-N population noise)."""
    n = max(n, 1)
    headroom = max(1, int(headroom))
    if headroom <= 1:
        c = ((n + quantum - 1) // quantum) * quantum
        p = quantum
        while p < c:
            p *= 2
        return p
    target = int(np.ceil(n * (1.0 + 0.15 * headroom)))
    p = 1
    while p < target:
        p *= 2
    step = max(p // 8, quantum)
    step = ((step + quantum - 1) // quantum) * quantum
    return ((target + step - 1) // step) * step


def bucketize(ps: ParticleSystem, M: int, caps: tuple[int, ...] | None = None,
              headroom: int = 1) -> LevelBuckets:
    """Split a flat ParticleSystem into per-level padded buckets on its
    device (the live rows of level l in their flat order, then zero rows
    with scale -1).  A capacity never shrinks below `caps`."""
    live = ps.mass > 0
    new_caps, buckets = [], []
    for l in range(M + 1):
        idx = torch.nonzero(live & (ps.level == l)).squeeze(1)
        n = idx.numel()
        cap = _pad_cap(n, 1, headroom)
        if caps is not None and caps[l] >= cap:
            cap = caps[l]
        new_caps.append(cap)

        def pad(a, fill=0.0):
            out = torch.full((cap,) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                             device=a.device)
            out[:n] = a.index_select(0, idx)
            return out

        buckets.append(ParticleSystem(
            x=pad(ps.x), v=pad(ps.v), mass=pad(ps.mass), acc=pad(ps.acc),
            pot=pad(ps.pot),
            level=torch.full((cap,), l, dtype=torch.int32, device=ps.x.device),
            indx=pad(ps.indx, 0), scale=pad(ps.scale, -1.0)))
    return LevelBuckets(buckets=buckets, caps=tuple(new_caps))


def flatten_buckets(buckets) -> ParticleSystem:
    """Concatenate buckets (a LevelBuckets or a sequence) back to a flat
    system, padding rows included."""
    bs = getattr(buckets, "buckets", buckets)
    return ParticleSystem(**{f: torch.cat([getattr(b, f) for b in bs])
                             for f in ("x", "v", "mass", "acc", "pot", "level",
                                       "indx", "scale")})


# ---------------------------------------------------------------------------
# Registers and the begin_run prime
# ---------------------------------------------------------------------------

def init_regs(forces: dict, couples: dict, state: dict, t0=0.0,
              centers=None, rots=None, feats=None,
              accum_dtype=torch.float32, prime_accel=True, with_diag=True,
              externals=(), extras=None):
    """Per-level registers and the acceleration at t0 (begin_run prime;
    exp_tpu's init_regs_sm on one device): returns (state, regs, coef_full,
    diag).  Both registers of a level hold its coefficients at t0; a
    playback component's registers are unused (zeros) and its assembled set
    is the playback set.

    prime_accel=False skips the acceleration pass: the relevel uses it,
    since the rebucket carries each particle's acc and pot from the last
    closing kick at the same time.  The acceleration is written into the
    buckets in place.  with_diag=False skips the diagnostics."""
    names = list(forces)
    feats = feats or {n: CompFeats() for n in names}
    centers = centers or {}
    rots = rots or {n: None for n in names}
    ex = extras or _NO_EXTRAS
    ctr = _com_centers(state, feats, centers)
    eff, tc = _eff_forces(forces, state, ctr)
    src = source_names(forces)
    regs, coef_full = {}, {}
    for n in names:
        if n in ex["playback"] or n in src:
            z = torch.zeros((1,), dtype=state[n][0].x.dtype,
                            device=state[n][0].x.device)
            regs[n] = ([z] * len(state[n]), [z] * len(state[n]))
            cf = ex["playback"].get(n, z)
            if n in ex["playback"] and n in ex["restrict"]:
                mk, off = ex["restrict"][n]
                cf = cf * mk + off
            coef_full[n] = cf
            continue
        if n in tc:
            cs = [_project_tc(eff[n], feats[n], b.x, b.mass, t0, ctr[n],
                              accum_dtype) for b in state[n]]
        else:
            cs = [_project(forces[n], feats[n], b.x, b.mass, t0, ctr[n],
                           accum_dtype, rot=rots[n]) for b in state[n]]
        regs[n] = (list(cs), list(cs))
        tot = cs[0]
        for c in cs[1:]:
            tot = tmap(torch.add, tot, c)
        coef_full[n] = _assemble_extras(n, tot, ex)
    srcs = {n: _sources_of(state[n]) for n in src}
    diag = {}
    for n in names:
        if prime_accel:
            for b in state[n]:
                acc, b.pot = _accel_at(b.x, t0, couples[n], eff, coef_full,
                                       ctr, rots, externals, tc=tc,
                                       sources=srcs)
                if n in ex["pseudo"]:
                    acc = acc - _pseudo_accel(ex["pseudo"][n], b.x, b.v,
                                              ctr[n])
                b.acc = acc
        if with_diag:
            diag[n] = _sum_diag(state[n])
    return state, regs, coef_full, diag


# ---------------------------------------------------------------------------
# The runner
# ---------------------------------------------------------------------------

class MultistepRunner:
    """Host orchestration on one device: big steps and boundary relevels.

    `forces` maps component name -> force (SphereSL, CylinderForce, ...),
    `couples` name -> the names whose fields act on it.  The state is a
    dict name -> list of M+1 bucket ParticleSystems, the registers a dict
    name -> ([L_0..L_M], [N_0..N_M]).  `externals` are external fields
    (forces/external.py), `wrappers` position wrappers (PeriodicBC)."""

    def __init__(self, forces: dict, couples: dict, dtime: float, M: int,
                 accum_dtype=torch.float32, dynparams=None,
                 shiftlevl: int = 0, externals=(), feats=None,
                 cap_headroom: int = 1, fused: bool = False,
                 eqmotion: bool = True, rebucket_style: str = "sortfull",
                 wrappers=()):
        self.forces = forces
        self.couples = couples
        self.dtime = float(dtime)
        self.M = int(M)
        self.accum_dtype = accum_dtype
        self.dyn = dynparams or {}
        self.shiftlevl = int(shiftlevl)
        self.feats = feats or {n: CompFeats() for n in forces}
        self.cap_headroom = int(cap_headroom)
        self.fused = bool(fused)        # the same eager loop either way
        self.eqmotion = bool(eqmotion)  # false freezes x and v (incpos.cc:75)
        self.rebucket_style = str(rebucket_style)
        self.externals = tuple(externals)
        self.wrappers = tuple(wrappers)
        if self.rebucket_style == "incremental":
            raise NotImplementedError(
                "rebucket_style='incremental' (the movers-only relevel) is "
                "not ported (ROADMAP item 9b.2); 'sortfull' and 'sortgather' "
                "run the port's one rebucket engine")
        if self.rebucket_style not in REBUCKET_STYLES:
            raise ValueError(f"rebucket_style={rebucket_style!r}: expected "
                             f"one of {REBUCKET_STYLES + ('incremental',)}")
        self.caps: dict = {}
        #: per-component (offlo, offhi, nlive) from the last relevel: live
        #: particles requesting finer-than-finest / coarser-than-dtime steps
        #: (multistep.cc:160-195)
        self.overrun: dict = {}
        #: relevels that rebuilt the registers, and those of them that grew
        #: the capacities on the host fallback
        self.n_rebuilds = 0
        self.n_fallbacks = 0

    # -- helpers ----------------------------------------------------------

    def _caps_sig(self, state):
        return tuple((n, tuple(b.x.shape[0] for b in bs))
                     for n, bs in state.items())

    def _rots(self, rots):
        return rots or {n: None for n in self.forces}

    @staticmethod
    def _extras(extras_fn, t):
        """The extras at time t: playback, hall, restrict and pseudo dicts
        (missing keys empty)."""
        if extras_fn is None:
            return _NO_EXTRAS
        ex = extras_fn(t)
        return {k: ex.get(k) or {} for k in _NO_EXTRAS}

    def _init(self, st, t0=0.0, centers=None, rots=None, prime_accel=True,
              with_diag=True, extras=None):
        return init_regs(self.forces, self.couples, st, t0=t0,
                         centers=centers, rots=self._rots(rots),
                         feats=self.feats, accum_dtype=self.accum_dtype,
                         prime_accel=prime_accel, with_diag=with_diag,
                         externals=self.externals, extras=extras)

    # -- entry points -----------------------------------------------------

    def init_state(self, flat: dict, t0=0.0, centers=None, extras_fn=None,
                   rots=None):
        """Initial leveling and bucketing from flat per-component systems
        (begin.cc:86-127's multistep prime): forces with every particle at
        level 0, levels from the dt criteria (unclamped: there is no
        previous level yet), then buckets and registers at those levels.
        Returns (state, regs, coef_full, diag)."""
        ex = self._extras(extras_fn, t0)
        state = {n: bucketize(ps, self.M, headroom=self.cap_headroom)
                 for n, ps in flat.items()}
        st = {n: lb.buckets for n, lb in state.items()}
        st, _, _, _ = self._init(st, t0, centers, rots, with_diag=False,
                                 extras=ex)
        flat2 = {}
        for n, bs in st.items():
            ps = flatten_buckets(bs)
            lev = assign_levels(dtreq_fn(ps, **self.dyn), ps.level,
                                self.dtime, self.M, 0)
            flat2[n] = replace(ps, level=torch.where(ps.mass > 0, lev, 0)
                               .to(torch.int32))
        state = {n: bucketize(ps, self.M, headroom=self.cap_headroom)
                 for n, ps in flat2.items()}
        self.caps = {n: lb.caps for n, lb in state.items()}
        st = {n: lb.buckets for n, lb in state.items()}
        return self._init(st, t0, centers, rots, extras=ex)

    def _substep(self, st, regs, t0, ms, centers, rots, ex):
        """Fine substep ms of the hierarchy, in place; returns coef_full.
        `ex` are the extras at this substep's drift time."""
        M, names = self.M, list(self.forces)
        mint = mintvl_table(M)
        dt = self.dtime / 2 ** M
        mfirst = mfirst_of(ms, M)
        mdrft = ms + 1
        t_sub = t0 + dt * mdrft

        # opening half-kick and full drift of the active levels (skipped
        # when eqmotion is off: incpos.cc:75, incvel.cc:93); the position
        # wrappers after each drift
        if self.eqmotion:
            for n in names:
                for l in range(mfirst, M + 1):
                    b = st[n][l]
                    DT = dt * mint[l]
                    b.v.add_(b.acc * (0.5 * DT))
                    b.x.add_(b.v * DT)
                    for wrp in self.wrappers:
                        b.x = wrp.wrap(b.x)

        ctr = _com_centers(st, self.feats, centers)
        # two-center inner = the resolved center, outer = the COM
        eff, tc = _eff_forces(self.forces, st, ctr)
        src = source_names(self.forces)

        # registers of the active levels: L <- N, N <- new, at the time of
        # the end of each level's own step (unused under playback and for
        # a source component)
        for n in names:
            if n in ex["playback"] or n in src:
                continue
            for l in range(mfirst, M + 1):
                b = st[n][l]
                t_lvl = t0 + dt * (ms + mint[l])
                if n in tc:     # the force applies its centers itself
                    cnew = _project_tc(eff[n], self.feats[n], b.x, b.mass,
                                       t_lvl, ctr[n], self.accum_dtype)
                else:
                    cnew = _project(self.forces[n], self.feats[n], b.x,
                                    b.mass, t_lvl, ctr[n], self.accum_dtype,
                                    rot=rots[n])
                regs[n][0][l] = regs[n][1][l]
                regs[n][1][l] = cnew

        # full coefficients at mdrft, static weights, the JAX order; a
        # playback set replaces them, then Hall and the restriction
        coef_full = {}
        for n in names:
            if n in src:
                coef_full[n] = torch.zeros((1,), dtype=st[n][0].x.dtype,
                                           device=st[n][0].x.device)
                continue
            if n in ex["playback"]:
                tot = ex["playback"][n]
                if n in ex["restrict"]:
                    mk, off = ex["restrict"][n]
                    tot = tot * mk + off
                coef_full[n] = tot
                continue
            tot = None
            for l in range(M + 1):
                w = ((ms % mint[l]) + 1) / mint[l]
                c = tmap(lambda L, N: L * (1.0 - w) + N * w, regs[n][0][l],
                         regs[n][1][l])
                tot = c if tot is None else tmap(torch.add, tot, c)
            coef_full[n] = _assemble_extras(n, tot, ex)

        # closing half-kick of the levels at their end boundary (the kicks
        # move no position, so a source component is gathered once)
        srcs = {n: _sources_of(st[n]) for n in src}
        for n in names:
            for l in range(M + 1):
                if mdrft % mint[l] != 0:
                    continue
                b = st[n][l]
                DT = dt * mint[l]
                acc, pot = _accel_at(b.x, t_sub, self.couples[n], eff,
                                     coef_full, ctr, rots, self.externals,
                                     tc=tc, sources=srcs)
                # the non-inertial frame correction, once a kick
                # (Component.H:913-921 AddAcc)
                if n in ex["pseudo"]:
                    acc = acc - _pseudo_accel(ex["pseudo"][n], b.x, b.v,
                                              ctr[n])
                if self.eqmotion:
                    b.v.add_(acc * (0.5 * DT))
                b.acc, b.pot = acc, pot
        return coef_full

    def bigstep(self, st, regs, t0=0.0, centers=None, extras_fn=None,
                rots=None):
        """One big step: the 2^M substeps in order, in place.  Returns
        (state, regs, coef_full, diag), coef_full and diag of the last
        substep; `extras_fn(t)` is called for each substep at its drift
        time t0 + dt (ms + 1)."""
        centers = centers or {}
        rots = self._rots(rots)
        coef = None
        dt = self.dtime / 2 ** self.M
        for ms in range(2 ** self.M):
            ex = self._extras(extras_fn, t0 + dt * (ms + 1))
            coef = self._substep(st, regs, t0, ms, centers, rots, ex)
        diag = {n: _sum_diag(bs) for n, bs in st.items()}
        return st, regs, coef, diag

    def _assess(self, st):
        """Flatten, dt criteria, new levels (live rows only), and one host
        read of the per-level live counts, the number of live particles
        that changed level and the overrun counts."""
        M = self.M
        flat, levs, stats = {}, {}, []
        for n, bs in st.items():
            ps = flatten_buckets(bs)
            dtr = dtreq_fn(ps, **self.dyn)
            live = ps.mass > 0
            lev = torch.where(live, assign_levels(dtr, ps.level, self.dtime,
                                                  M, self.shiftlevl), 0)
            flat[n], levs[n] = ps, lev.to(torch.int32)
            key = torch.where(live, lev, M + 1).long()
            counts = torch.bincount(key, minlength=M + 2)[:M + 1]
            # overrun from the unclamped request (multistep.cc:160-195)
            nraw = _raw_levels(dtr, self.dtime)
            stats.append(torch.cat([
                counts, torch.stack([
                    torch.sum((lev != ps.level) & live),
                    torch.sum(live & (nraw > M)),
                    torch.sum(live & (dtr > self.dtime)),
                    torch.sum(live)]).long()]))
        host = torch.stack(stats).cpu().numpy()
        counts = {n: [int(c) for c in h[:M + 1]] for n, h in zip(st, host)}
        nchanged = int(host[:, M + 1].sum())
        over = {n: tuple(int(c) for c in h[M + 2:]) for n, h in zip(st, host)}
        return flat, levs, counts, nchanged, over

    def _rebucket(self, ps, lev, counts, caps):
        """The buckets of one component at fixed capacities: a stable sort
        of the level key (dead rows last), one gather of the 12 float
        columns packed together and one int32 gather of indx, then each
        level's rows into a zero-padded bucket."""
        M = self.M
        key = torch.where(ps.mass > 0, lev, M + 1)
        order = torch.sort(key, stable=True).indices
        packed = torch.cat([ps.x, ps.v, ps.acc, ps.mass[:, None],
                            ps.pot[:, None], ps.scale[:, None]], dim=1)
        sp = packed.index_select(0, order)
        si = ps.indx.index_select(0, order)
        bs, start = [], 0
        for l in range(M + 1):
            c, cap = counts[l], caps[l]
            blk = torch.zeros((cap, 12), dtype=sp.dtype, device=sp.device)
            blk[:c] = sp[start:start + c]
            ib = torch.zeros((cap,), dtype=si.dtype, device=si.device)
            ib[:c] = si[start:start + c]
            start += c
            bs.append(ParticleSystem(
                x=blk[:, 0:3].contiguous(), v=blk[:, 3:6].contiguous(),
                acc=blk[:, 6:9].contiguous(), mass=blk[:, 9].contiguous(),
                pot=blk[:, 10].contiguous(),
                level=torch.full((cap,), l, dtype=torch.int32,
                                 device=sp.device),
                indx=ib, scale=blk[:, 11].contiguous()))
        return bs

    def relevel(self, st, regs, t0=0.0, centers=None, extras_fn=None,
                rots=None):
        """Boundary relevel (NoSwitch discipline); returns (state, regs).

        The registers are rebuilt at the synchronised time, where every
        level's L and N coincide, so no tableau state is lost; acc and pot
        are carried through the rebucket.  When no live particle changed
        level the state and registers are returned as they are.  When a
        level outgrew its bucket, the buckets are rebuilt with grown
        capacities (bucketize, the JAX package's host fallback)."""
        ex = self._extras(extras_fn, t0)
        flat, levs, counts, nchanged, over = self._assess(st)
        self.overrun = over
        if nchanged == 0:
            return st, regs
        fits = all(c <= self.caps[n][l] for n, cs in counts.items()
                   for l, c in enumerate(cs))
        if fits:
            st2 = {n: self._rebucket(flat[n], levs[n], counts[n], self.caps[n])
                   for n in flat}
        else:
            self.n_fallbacks += 1
            state = {n: bucketize(replace(ps, level=levs[n]), self.M,
                                  caps=self.caps.get(n),
                                  headroom=self.cap_headroom)
                     for n, ps in flat.items()}
            self.caps = {n: lb.caps for n, lb in state.items()}
            st2 = {n: lb.buckets for n, lb in state.items()}
        self.n_rebuilds += 1
        st2, regs2, _, _ = self._init(st2, t0, centers, rots,
                                      prime_accel=False, with_diag=False,
                                      extras=ex)
        return st2, regs2

    def level_counts(self, st):
        """Live particles per level of each component (one host read)."""
        cts = torch.stack([torch.sum(b.mass > 0) for bs in st.values()
                           for b in bs]).cpu().numpy()
        out, k = {}, 0
        for n, bs in st.items():
            out[n] = [int(c) for c in cts[k:k + len(bs)]]
            k += len(bs)
        return out
