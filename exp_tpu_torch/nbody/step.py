"""KDK leapfrog step on one device (port of exp_tpu/nbody/step.py).

One step = half-kick -> drift -> coefficients -> acceleration -> half-kick,
with the conserved-quantity diagnostics of the reference's OutLog (KE, PE,
Clausius virial VC, 2T/VC) computed from the new state.  With a World of
several ranks (`world`), each rank steps its own rows: the coefficients
are summed over the ranks once a step, after the kernel, and so are the
diagnostics (exp_tpu's psum over `axis_name`).

Unlike the JAX step, which returns a new state, this step updates the
ParticleSystem in place and returns the same object: x and v by in-place
adds, acc and pot by the force's new output tensors.  At 1M particles that
saves allocating and copying the x and v arrays every step.
"""

from __future__ import annotations

import torch

from exp_tpu_torch.parallel.distributed import (all_reduce,
                                                world_coefficients)

_DIAG_KEYS = ("KE", "PE", "VC", "mass", "mom", "com", "L")


def _diagnostics(ps, world=None):
    """KE, PE, VC (Clausius virial), momentum, centre of mass, angular
    momentum and mass, as 0-d / (3,) tensors on the state's device; summed
    over the ranks of `world` in one all-reduce."""
    m = ps.mass
    ke = 0.5 * torch.sum(m * torch.sum(ps.v * ps.v, dim=-1))
    pe = 0.5 * torch.sum(m * ps.pot)           # self-energy: 1/2 sum m phi
    vc = torch.sum(m * torch.sum(ps.x * ps.acc, dim=-1))
    mom = torch.sum(m[:, None] * ps.v, dim=0)
    com = torch.sum(m[:, None] * ps.x, dim=0)
    ang = torch.sum(m[:, None] * torch.linalg.cross(ps.x, ps.v), dim=0)
    d = {"KE": ke, "PE": pe, "VC": vc, "mass": torch.sum(m),
         "mom": mom, "com": com, "L": ang}
    return reduce_diag(d, world)


def reduce_diag(d, world=None):
    """A diagnostics dict summed over the ranks of `world`, in one
    all-reduce of its values packed together."""
    if world is None or world.size == 1:
        return d
    flat = all_reduce(torch.cat([d[k].reshape(-1) for k in _DIAG_KEYS]),
                      world)
    out, k = {}, 0
    for key in _DIAG_KEYS:
        n = d[key].numel()
        out[key] = flat[k:k + n].reshape(d[key].shape)
        k += n
    return out


def _accel(force, coef, x, world):
    """A source (direct) force takes the world for its ring."""
    if getattr(force, "needs_sources", False):
        return force.acceleration(coef, x, group=world)
    return force.acceleration(coef, x)


def _step_body(force, dt, ps, accum_dtype=torch.float32, world=None):
    ps.v.add_(ps.acc * dt * 0.5)                     # half kick (in place)
    ps.x.add_(ps.v * dt)                             # drift (in place)
    coef = world_coefficients(force, ps.x, ps.mass, world,
                              accum_dtype=accum_dtype)
    acc, pot = _accel(force, coef, ps.x, world)
    ps.v.add_(acc * dt * 0.5)                        # half kick (in place)
    ps.acc, ps.pot = acc, pot
    return ps, coef, _diagnostics(ps, world)


def make_kdk_step(force, dt, accum_dtype=torch.float32, world=None):
    """A KDK step: step(ps) -> (ps, coef, diag), updating ps in place;
    `world`: this rank's World (its rows of the state)."""
    def step(ps):
        return _step_body(force, dt, ps, accum_dtype=accum_dtype,
                          world=world)
    return step


def init_force_state(force, ps, accum_dtype=torch.float32, world=None):
    """Initial coefficients, acceleration and potential (the reference's
    begin_run prime, src/begin.cc:86-127); sets ps.acc and ps.pot in place
    and returns (ps, coef, diag)."""
    coef = world_coefficients(force, ps.x, ps.mass, world,
                              accum_dtype=accum_dtype)
    ps.acc, ps.pot = _accel(force, coef, ps.x, world)
    return ps, coef, _diagnostics(ps, world)


def energies(diag):
    """Scalar summary of a diag dict (on the host).

    "E" = KE + VC is the reference OUTLOG's total-energy column (a virial
    proxy); "Etot" = KE + PE is the conserved total."""
    ke = float(diag["KE"])
    pe = float(diag["PE"])
    vc = float(diag["VC"])
    return {"KE": ke, "PE": pe, "VC": vc, "E": ke + vc, "Etot": ke + pe,
            "2T/VC": -2.0 * ke / vc if vc != 0 else float("nan")}
