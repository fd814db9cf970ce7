"""KDK leapfrog step on one device (port of exp_tpu/nbody/step.py).

One step = half-kick -> drift -> coefficients -> acceleration -> half-kick,
with the conserved-quantity diagnostics of the reference's OutLog (KE, PE,
Clausius virial VC, 2T/VC) computed from the new state.  The coefficient
all-reduce across devices comes with the multi-device slice.

Unlike the JAX step, which returns a new state, this step updates the
ParticleSystem in place and returns the same object: x and v by in-place
adds, acc and pot by the force's new output tensors.  At 1M particles that
saves allocating and copying the x and v arrays every step.
"""

from __future__ import annotations

import torch


def _diagnostics(ps):
    """KE, PE, VC (Clausius virial), momentum, centre of mass, angular
    momentum and mass, as 0-d / (3,) tensors on the state's device."""
    m = ps.mass
    ke = 0.5 * torch.sum(m * torch.sum(ps.v * ps.v, dim=-1))
    pe = 0.5 * torch.sum(m * ps.pot)           # self-energy: 1/2 sum m phi
    vc = torch.sum(m * torch.sum(ps.x * ps.acc, dim=-1))
    mom = torch.sum(m[:, None] * ps.v, dim=0)
    com = torch.sum(m[:, None] * ps.x, dim=0)
    ang = torch.sum(m[:, None] * torch.linalg.cross(ps.x, ps.v), dim=0)
    return {"KE": ke, "PE": pe, "VC": vc, "mass": torch.sum(m),
            "mom": mom, "com": com, "L": ang}


def _step_body(force, dt, ps, accum_dtype=torch.float32):
    ps.v.add_(ps.acc * dt * 0.5)                     # half kick (in place)
    ps.x.add_(ps.v * dt)                             # drift (in place)
    coef = force.coefficients(ps.x, ps.mass, accum_dtype=accum_dtype)
    acc, pot = force.acceleration(coef, ps.x)
    ps.v.add_(acc * dt * 0.5)                        # half kick (in place)
    ps.acc, ps.pot = acc, pot
    return ps, coef, _diagnostics(ps)


def make_kdk_step(force, dt, accum_dtype=torch.float32):
    """A KDK step: step(ps) -> (ps, coef, diag), updating ps in place."""
    def step(ps):
        return _step_body(force, dt, ps, accum_dtype=accum_dtype)
    return step


def init_force_state(force, ps, accum_dtype=torch.float32):
    """Initial coefficients, acceleration and potential (the reference's
    begin_run prime, src/begin.cc:86-127); sets ps.acc and ps.pot in place
    and returns (ps, coef, diag)."""
    coef = force.coefficients(ps.x, ps.mass, accum_dtype=accum_dtype)
    ps.acc, ps.pot = force.acceleration(coef, ps.x)
    return ps, coef, _diagnostics(ps)


def energies(diag):
    """Scalar summary of a diag dict (on the host).

    "E" = KE + VC is the reference OUTLOG's total-energy column (a virial
    proxy); "Etot" = KE + PE is the conserved total."""
    ke = float(diag["KE"])
    pe = float(diag["PE"])
    vc = float(diag["VC"])
    return {"KE": ke, "PE": pe, "VC": vc, "E": ke + vc, "Etot": ke + pe,
            "2T/VC": -2.0 * ke / vc if vc != 0 else float("nan")}
