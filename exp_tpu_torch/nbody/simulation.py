"""Simulation driver: config -> components -> run loop (port of
exp_tpu/nbody/simulation.py on one device).

The orchestration layer — the analogue of the reference's expand.cc main
loop + ComponentContainer + OutputContainer (src/expand.cc:169-575,
src/ComponentContainer.cc, src/OutputContainer.cc):

* builds each component's force from its YAML stanza (force factory,
  Component.cc:1077-1108),
* reads body files (ascii or PSP) onto the run's device,
* steps all components by the KDK leapfrog — component interactions follow
  the reference's Interaction/allcouples pairing (ComponentContainer.cc:
  309-424, :580-867): every component's particles feel the force of every
  coupled component's basis expansion — or, with `Global.multistep`, by
  the port's MultistepRunner (nbody/multistep.py),
* dispatches periodic outputs (OutLog / OutCoef / checkpoints / PSP) on the
  host.

Where exp_tpu runs `steps_per_block` steps inside one jit (a lax.scan),
this driver runs them as a plain loop of steps: a block still ends on every
output-due step, and the coefficients and diagnostics of its last step come
to the host in one transfer.  `fused_bigstep` is passed to the runner as
`fused=`, which runs its eager loop.  A CUDA graph of the step is
performance work (ROADMAP's perf_opt item 9b.1), not part of the driver.

`fpe: trace` sets jax_debug_nans in exp_tpu, which has no PyTorch
counterpart: here it runs the `fpe: true` guard, `_check_bad_values`, which
checks the diagnostics and coefficients after every block and dumps a
checkpoint before raising.

Not ported, each raising NotImplementedError with its ROADMAP item: the
multi-process world (item 12); the force ids bessel, CBsphere, hernq,
direct, shells, halobulge and twocenter (item 11); and, item 10b, EJ
centering, nEJaccel and centerfile (nbody/centering.py), coefficient
playback and NOISE, the External stanza (forces/external.py, PeriodicBC),
Hall/PCA smoothing (npca, nbody/pca.py), harmonic restrictions, and
`self_consistent: false` under multistep (the runner's playback extras).
"""

from __future__ import annotations

import hashlib
import os
import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from exp_tpu_torch import resolve_device
from exp_tpu_torch.config import ComponentConfig, ConfigError, RunConfig
from exp_tpu_torch.nbody.multistep import (CompFeats, _com_centers,
                                           _project, flatten_buckets)
from exp_tpu_torch.nbody.particles import ParticleSystem, _host, read_bodies
from exp_tpu_torch.nbody.step import _diagnostics

#: the force ids of exp_tpu's factory that this port does not build yet
_UNPORTED_FORCES = ("bessel", "CBsphere", "hernq", "direct", "shells",
                    "halobulge", "twocenter")

#: harmonic-restriction keys of the sphere and polar bases
#: (SphericalBasis.cc:33-39; PolarBasis.cc:36-45, Cylinder.cc valid_keys)
_SPHERE_RESTRICT = ("NO_L0", "NO_L1", "EVEN_L", "EVEN_M", "M0_ONLY", "FIX_L0")
_POLAR_RESTRICT = ("NO_M0", "NO_M1", "EVEN_M", "M0_ONLY", "mlim")

_PS_FIELDS = ("x", "v", "mass", "acc", "pot", "level", "indx", "scale")


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ConfigError(f"not a floating dtype: {name!r}")
    return dt


def _fetch(tree):
    """A nested dict of tensors as the same dict of NumPy arrays, in one
    device-to-host transfer: every leaf flattened into one f64 buffer
    (complex leaves as their (re, im) pairs), then cut and cast back to its
    dtype (exact: f32 -> f64 -> f32 rounds nothing)."""
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        else:
            leaves.append(t)

    walk(tree)
    if not leaves:
        return tree
    parts = [torch.view_as_real(t.detach()) if t.is_complex() else t.detach()
             for t in leaves]
    flat = torch.cat([p.reshape(-1).to(torch.float64) for p in parts])
    host = flat.cpu().numpy()
    out, k = [], 0
    for t, p in zip(leaves, parts):
        n = p.numel()
        a = host[k:k + n].reshape(p.shape)
        k += n
        if t.is_complex():
            a = a[..., 0] + 1j * a[..., 1]
        out.append(a.astype(str(t.dtype).replace("torch.", "")))
    it = iter(out)

    def build(t):
        if isinstance(t, dict):
            return {k_: build(v) for k_, v in t.items()}
        return next(it)

    return build(tree)


# ---------------------------------------------------------------------------
# Force factory
# ---------------------------------------------------------------------------

def build_force(fc, dtype, workdir=".", particles=None, device=None):
    """Instantiate a force from its config stanza (host-side table builds)
    on `device` (None: CUDA, raising when there is none).

    `particles`: optional (x, mass) host arrays of the owning component,
    used when a basis conditions on the snapshot itself (cylinder
    `conditioning: particles`, the reference's accumulate_eof path)."""
    p = dict(fc.parameters)
    device = resolve_device(device)
    if fc.id == "sphereSL":
        from exp_tpu_torch.basis.model import SphericalModelTable
        from exp_tpu_torch.basis.slgrid import build_sph_sl_tables
        from exp_tpu_torch.forces.spherical import SphereSL

        model = p.pop("_model_object", None)   # adaptive-rebuild path
        modelname = p.pop("modelname", "SLGridSph.model")
        if model is None:
            mpath = os.path.join(workdir, str(modelname))
            if os.path.exists(mpath):
                model = SphericalModelTable.from_file(mpath)
            else:
                # builtin analytic models: hernquist[:a=..,M=..], plummer...
                from exp_tpu_torch.cli._common import load_model

                model = load_model(modelname)
        p.pop("dtime", None)        # adaptive recompute interval (driver)
        p.pop("modeltype", None)
        cachename = p.pop("cachename", None)
        if cachename is not None:
            cachename = os.path.join(workdir, cachename)
        lmax = int(p.pop("Lmax", 4))
        nmax = int(p.pop("nmax", 10))
        numr = int(p.pop("numr", 2000))
        rmin = p.pop("rmin", None)
        rmax = p.pop("rmax", None)
        rmap = float(p.pop("rmapping", 0.067))
        cmap = int(p.pop("cmap", 1))
        scale = float(p.pop("scale", 1.0))
        backend = str(p.pop("backend", "matmul"))
        t = build_sph_sl_tables(model, lmax=lmax, nmax=nmax, numr=numr,
                                rmin=None if rmin is None else float(rmin),
                                rmax=None if rmax is None else float(rmax),
                                cmap=cmap, rmap=rmap, cachename=cachename)
        return SphereSL.from_tables(
            t, scale=scale, dtype=dtype, backend=backend,
            pallas_precision=str(p.pop("pallas_precision", "mixed")),
            pallas_interp=str(p.pop("pallas_interp", "spline")),
            numr_cs=int(p.pop("numr_cs", 256)),
            pallas_harmonics=str(p.pop("pallas_harmonics", "auto")),
            device=device)
    elif fc.id == "noforce":
        from exp_tpu_torch.forces.noforce import NoForce

        return NoForce()
    elif fc.id == "cube":
        from exp_tpu_torch.forces.cube import Cube

        return Cube.create(
            nmaxx=int(p.pop("nmaxx", 6)), nmaxy=int(p.pop("nmaxy", 6)),
            nmaxz=int(p.pop("nmaxz", 6)), dtype=dtype,
            backend=str(p.pop("backend", "einsum")),
            pallas_precision=str(p.pop("pallas_precision", "mixed")),
            device=device)
    elif fc.id == "cylinder":
        from exp_tpu_torch.basis.empcyl import build_empcyl_tables
        from exp_tpu_torch.forces.cylinder import CylinderForce

        cachename = p.pop("cachename", p.pop("eof_file", None))
        if cachename is not None:
            cachename = os.path.join(workdir, cachename)
        disk_density = None
        density_key = None
        if str(p.pop("conditioning", "analytic")) == "particles":
            if particles is None:
                raise ConfigError("cylinder conditioning: particles needs "
                                  "the component's bodyfile")
            from exp_tpu_torch.basis.empcyl import disk_density_from_particles

            disk_density = disk_density_from_particles(*particles)
            h = hashlib.sha256()
            for a in particles:
                h.update(np.ascontiguousarray(a).tobytes())
            density_key = "particles:" + h.hexdigest()[:16]
        t = build_empcyl_tables(
            disk_density=disk_density, density_key=density_key,
            mmax=int(p.pop("mmax", 6)), nmax=int(p.pop("nmax", 18)),
            ncylodd=p.pop("ncylodd", None),
            lmaxfid=int(p.pop("lmaxfid", 48)),
            nmaxfid=int(p.pop("nmaxfid", 32)),
            acyl=float(p.pop("acyl", 0.01)), hcyl=float(p.pop("hcyl", 0.002)),
            rcylmin=float(p.pop("rcylmin", 1e-3)),
            rcylmax=float(p.pop("rcylmax", 20.0)),
            numx=int(p.pop("ncylnx", 256)), numy=int(p.pop("ncylny", 128)),
            rnum=int(p.pop("rnum", 200)), tnum=int(p.pop("tnum", 80)),
            cachename=cachename)
        return CylinderForce.from_tables(
            t, dtype=dtype, backend=str(p.pop("backend", "xla")),
            pallas_precision=str(p.pop("pallas_precision", "default")),
            pallas_interp=str(p.pop("pallas_interp", "spline")),
            device=device)
    elif fc.id in ("flatdisk", "CBDisk"):
        from exp_tpu_torch.basis.flatdisk import build_flatdisk_tables
        from exp_tpu_torch.forces.cylinder import CylinderForce

        cachename = p.pop("cachename", None)
        if cachename is not None:
            cachename = os.path.join(workdir, cachename)
        # CBDisk: the analytic Clutton-Brock 2D set is the Kuzmin-conditioned
        # basis (its lowest member IS the Kuzmin disk) — same span
        model = p.pop("background", "kuzmin" if fc.id == "CBDisk" else "expon")
        if isinstance(model, dict):
            model = model.get("name", "expon")
        t = build_flatdisk_tables(
            mmax=int(p.pop("Mmax", p.pop("mmax", 6))),
            nmax=int(p.pop("nmax", 10)), model=str(model),
            acyl=float(p.pop("acyl", p.pop("scale", 1.0))),
            rcylmin=float(p.pop("rcylmin", 1e-3)),
            rcylmax=float(p.pop("rcylmax", 20.0)),
            numx=int(p.pop("numx", 256)), numy=int(p.pop("numy", 128)),
            knots=int(p.pop("knots", 400)), numk=int(p.pop("numk", 256)),
            cachename=cachename)
        return CylinderForce.from_tables(
            t, dtype=dtype, backend=str(p.pop("backend", "xla")),
            pallas_precision=str(p.pop("pallas_precision", "default")),
            pallas_interp=str(p.pop("pallas_interp", "spline")),
            device=device)
    elif fc.id == "slabSL":
        from exp_tpu_torch.basis.slab import build_slab_tables
        from exp_tpu_torch.forces.slab import SlabForce

        cachename = p.pop("cachename", None)
        if cachename is not None:
            cachename = os.path.join(workdir, cachename)
        t = build_slab_tables(
            nmaxx=int(p.pop("nmaxx", 4)), nmaxy=int(p.pop("nmaxy", 4)),
            nmax=int(p.pop("nmaxz", p.pop("nmax", 6))),
            zmax=float(p.pop("zmax", 0.1)), h=float(p.pop("hslab", 0.01)),
            # reference SLGridSlab knobs: background model type
            # (iso/const/para) and the construction method ('sl' = the
            # Sturm-Liouville solve like SLGridSlab; 'greens' = exact
            # Green's-function pairs, the default)
            type=str(p.pop("type", "iso")),
            method=str(p.pop("method", "greens")),
            cachename=cachename)
        return SlabForce.from_tables(
            t, dtype=dtype, backend=str(p.pop("backend", "einsum")),
            device=device)
    elif fc.id in _UNPORTED_FORCES:
        raise NotImplementedError(
            f"force id {fc.id!r} is not ported (ROADMAP item 11)")
    raise ConfigError(f"force id {fc.id!r} not implemented yet")


# ---------------------------------------------------------------------------
# Components
# ---------------------------------------------------------------------------

@dataclass
class Component:
    name: str
    force: object
    ps: ParticleSystem
    config: ComponentConfig
    self_consistent: bool = True
    # adiabatic turn-on (Component::Adiabatic, the reference's ton/twid ramp)
    adiabatic: bool = False
    ton: float = 0.0
    twid: float = 1.0
    # adaptive basis recomputation (Sphere 'dtime' option, Sphere.cc:50-52)
    basis_dtime: float = 0.0
    basis_tnext: float = 0.0
    # particles beyond rtrunc (from the center) do not contribute to the
    # expansion but still feel it (Component.H:136-139)
    rtrunc: float = 1.0e20
    # expand about the component's instantaneous center of mass
    # (Component.H:155-163 'Local' frame, `com: true`)
    com_system: bool = False

    @property
    def feats(self) -> CompFeats:
        return CompFeats(adiabatic=self.adiabatic, ton=self.ton,
                         twid=self.twid, rtrunc=self.rtrunc,
                         com_system=self.com_system)


def _refuse_features(cc: ComponentConfig):
    """The component and force options of exp_tpu's driver that are not
    ported: NotImplementedError with the ROADMAP item."""
    cp = cc.parameters or {}
    fp = cc.force.parameters or {}
    where = f"component {cc.name!r}"
    for key, what in (("EJ", "EJ center/axis tracking"),
                      ("nEJaccel", "the nEJaccel frame acceleration"),
                      ("centerfile", "a centerfile trajectory")):
        if cp.get(key):
            raise NotImplementedError(
                f"{where}: {what} needs nbody/centering.py, which is not "
                "ported (ROADMAP item 10b)")
    if cp.get("playback"):
        raise NotImplementedError(
            f"{where}: coefficient playback is not ported (ROADMAP item 10b)")
    if int(cp.get("npca", 0)) > 0:
        raise NotImplementedError(
            f"{where}: npca (Hall/PCA smoothing) needs nbody/pca.py, which is "
            "not ported (ROADMAP item 10b)")
    if fp.get("NOISE") and cc.force.id in ("sphereSL", "bessel"):
        raise NotImplementedError(
            f"{where}: coefficient NOISE is not ported (ROADMAP item 10b)")
    if (cc.force.id in ("sphereSL", "bessel")
            and any(fp.get(k) for k in _SPHERE_RESTRICT)) or (
            cc.force.id in ("cylinder", "flatdisk", "CBDisk")
            and any(fp.get(k) is not None and fp.get(k) is not False
                    for k in _POLAR_RESTRICT)):
        raise NotImplementedError(
            f"{where}: harmonic restrictions are not ported (ROADMAP item "
            "10b)")


class Simulation:
    """Multi-component BFE N-body run on one device (None: CUDA, raising
    when there is none)."""

    def __init__(self, config: RunConfig, workdir=".", device=None,
                 steps_per_block: int | None = None):
        if (torch.distributed.is_available()
                and torch.distributed.is_initialized()
                and torch.distributed.get_world_size() > 1):
            raise NotImplementedError(
                "the multi-process driver is not ported (ROADMAP item 12)")
        self.config = config
        self.workdir = workdir
        self.device = resolve_device(device)
        g = config.glob
        self.dt = float(g.dtime)
        self.nsteps = int(g.nsteps)
        self.runtag = g.runtag
        # outdir resolution: an explicit homedir prefixes relative outdirs
        # (parse.cc:231-234); use_cwd roots them at the process cwd
        # (parse.cc:123); default is the workdir
        base = workdir
        if getattr(g, "homedir", ""):
            base = g.homedir
        elif getattr(g, "use_cwd", False):
            base = os.getcwd()
        self.outdir = os.path.join(base, g.outdir)
        os.makedirs(self.outdir, exist_ok=True)
        self.time = 0.0
        self.istep = 0
        self.compute_dtype = _torch_dtype(g.compute_dtype)
        self.accum_dtype = _torch_dtype(g.accum_dtype)
        if any(e for e in (config.external or [])):
            raise NotImplementedError(
                "the External stanza (external fields, PeriodicBC) needs "
                "forces/external.py, which is not ported (ROADMAP item 10b)")

        # components
        self.components: dict[str, Component] = {}
        for cc in config.components:
            if cc.bodyfile is None:
                raise ConfigError(f"component {cc.name}: no bodyfile")
            _refuse_features(cc)
            cp = cc.parameters or {}
            # bodyfile may be reference ascii OR a PSP binary snapshot
            # (sniffed by magic) — the name inside a multi-component PSP
            # defaults to this component's name
            ps = read_bodies(os.path.join(workdir, cc.bodyfile),
                             dtype=self.compute_dtype,
                             component=cp.get("psp_component", cc.name),
                             scale_dattr=cp.get("scale_dattr"),
                             device=self.device)
            if g.nbodmax and ps.n > g.nbodmax:
                raise ConfigError(
                    f"component {cc.name}: {ps.n} bodies exceeds "
                    f"nbodmax={g.nbodmax}")
            cond = None
            if (cc.force.id == "cylinder" and (cc.force.parameters or {})
                    .get("conditioning") == "particles"):
                cond = (_host(ps.x), _host(ps.mass))
            force = build_force(cc.force, self.compute_dtype, workdir,
                                particles=cond, device=self.device)
            c0 = Component(
                name=cc.name, force=force, ps=ps, config=cc,
                self_consistent=bool(cc.force.parameters.get(
                    "self_consistent", True)),
                adiabatic=bool(cp.get("adiabatic", False)),
                ton=float(cp.get("ton", 0.0)),
                twid=float(cp.get("twid", 1.0)),
                rtrunc=float(cp.get("rtrunc", 1.0e20)),
                com_system=bool(cp.get("com", False)),
                basis_dtime=float(cc.force.parameters.get("dtime", 0.0)
                                  if cc.force.id == "sphereSL" else 0.0))
            c0.basis_tnext = c0.basis_dtime
            self.components[cc.name] = c0
        #: frozen coefficient sets for `self_consistent: false` components
        #: (captured from the initial projection at prime, in the compute
        #: dtype, as exp_tpu injects them; the expansion never responds to
        #: the live particles — the reference's fixed-potential component)
        self._frozen = {}

        # interaction couples: an entry `a: b` means "b feels a", ONE-WAY
        # (Interaction.l is "components whose particles will feel the force
        # from c", ComponentContainer.H:27-35, .cc:410-440); list mutual
        # pairs explicitly.  Deduped: a repeated/reciprocal entry must not
        # double-apply gravity.
        names = list(self.components)
        self.couples: dict[str, list[str]] = {b: [b] for b in names}
        if config.interactions:
            for a, b in config.interactions:
                if a not in names or b not in names:
                    raise ConfigError(f"Interaction {a}:{b}: unknown component")
                if a not in self.couples[b]:
                    self.couples[b].append(a)
        elif config.glob.allcouples:
            for b in names:
                self.couples[b] = list(names)

        # outputs; on an `infile:` restart the writers CONTINUE existing
        # files instead of truncating them (which would also destroy the
        # old outputs before restore_checkpoint even runs).  restart_as_new
        # reads the checkpoint bodies but starts a NEW run with fresh
        # outputs (parse.cc:243 ignore_info)
        self.is_restart = bool(config.glob.infile) and not bool(
            getattr(config.glob, "restart_as_new", False))
        self.outputs = [self._make_output(o) for o in config.outputs]
        self._nint_gcd = 1
        nints = [o.nint for o in self.outputs if o.nint > 0]
        if nints:
            self._nint_gcd = int(np.gcd.reduce(nints))
        self.steps_per_block = (steps_per_block if steps_per_block
                                else self._nint_gcd)

        # graceful-stop machinery (the reference's chkTimer + signal paths,
        # src/chkTimer.cc, expand.cc:236-257,430-437)
        self.stop_requested = False
        self.dump_requested = False
        # wall-clock budget: Global.runtime is in HOURS (chkTimer.cc:62);
        # run.py --wall (seconds) overrides
        self.wall_limit = (float(g.runtime) * 3600.0
                           if getattr(g, "runtime", -1.0) > 0 else None)
        self.restart_cmd = getattr(g, "restart_cmd", "") or None
        #: progress report cadence in steps (reference nreport, global.H:56)
        self.nreport = int(getattr(g, "nreport", 0))
        #: eqmotion: false freezes the phase space — coefficients, forces
        #: and outputs still run every step (incpos.cc:75, incvel.cc:93)
        self.eqmotion = bool(getattr(g, "eqmotion", True))
        self._wall0 = time.time()
        # per-phase wall-clock timers (the reference's step timers printed
        # at VERBOSE>3, src/step.cc:28-29,347-374)
        self.verbose = int(getattr(config.glob, "VERBOSE", 0))
        self.timers = {k: 0.0 for k in ("Compute", "Output", "Relevel")}
        self._state = {n: c.ps for n, c in self.components.items()}
        self._coefs = None
        self._diag = None
        self._host_cache = {}           # name -> host ParticleSystem
        self._host_cache_step = {}      # name -> istep of the cached copy

        # multistep machinery (Global.multistep > 0)
        self.M = int(g.multistep)
        self._ms_runner = None
        self._ms_state = None
        self._ms_regs = None
        if self.M > 0:
            from exp_tpu_torch.nbody.multistep import MultistepRunner

            for n, c in self.components.items():
                if not c.self_consistent:
                    raise NotImplementedError(
                        f"component {n!r}: self_consistent: false under "
                        "multistep rides the runner's playback extras, "
                        "which are not ported (ROADMAP item 10b)")
            self._ms_runner = MultistepRunner(
                {n: c.force for n, c in self.components.items()},
                self.couples, self.dt, self.M, accum_dtype=self.accum_dtype,
                dynparams={"dynfracV": g.dynfracV, "dynfracA": g.dynfracA,
                           "dynfracP": g.dynfracP, "dynfracD": g.dynfracD,
                           "dynfracS": g.dynfracS},
                shiftlevl=g.shiftlevl,
                feats={n: c.feats for n, c in self.components.items()},
                fused=g.fused_bigstep, cap_headroom=g.cap_headroom,
                eqmotion=self.eqmotion)

    # ------------------------------------------------------------------
    # stepping
    # ------------------------------------------------------------------

    def _project_and_accel(self, state, t):
        """Per-component projection + acceleration: coefficients with the
        adiabatic ramp, rtrunc and COM frame applied (frozen coefficients
        for `self_consistent: false`), then every component's acceleration
        and potential from the coupled fields — shared by the step and the
        initial prime so that features are honored identically in both
        (reference: the same determine_coefficients path for begin_run and
        do_step)."""
        feats = {n: self.components[n].feats for n in state}
        ctr = _com_centers({n: [ps] for n, ps in state.items()}, feats, {})
        coefs = {}
        for n, ps in state.items():
            if n in self._frozen:
                coefs[n] = self._frozen[n]
            else:
                coefs[n] = _project(self.components[n].force, feats[n], ps.x,
                                    ps.mass, t, ctr[n], self.accum_dtype)
        accs, pots = {}, {}
        for n, ps in state.items():
            acc = pot = None
            for a in self.couples[n]:
                xa = ps.x if ctr[a] is None else ps.x - ctr[a][None, :]
                aa, pp = self.components[a].force.acceleration(coefs[a], xa)
                acc = aa if acc is None else acc + aa
                pot = pp if pot is None else pot + pp
            accs[n], pots[n] = acc, pot
        return coefs, accs, pots

    def _step(self, t_new):
        """One KDK step of every component, in place; t_new is the time at
        the end of the step.  Returns (coefs, diag) on the device."""
        # eqmotion: false freezes x/v (reference incpos.cc:75/incvel.cc:93
        # return early) while the field evaluation below still runs
        dt = self.dt if self.eqmotion else 0.0
        for ps in self._state.values():
            ps.v.add_(ps.acc * (dt * 0.5))          # half kick
            ps.x.add_(ps.v * dt)                    # drift
        coefs, accs, pots = self._project_and_accel(self._state, t_new)
        for n, ps in self._state.items():
            ps.v.add_(accs[n] * (dt * 0.5))         # half kick
            ps.acc, ps.pot = accs[n], pots[n]
        return coefs, {n: _diagnostics(ps) for n, ps in self._state.items()}

    def prime(self):
        """Initial coefficient/force evaluation (begin_run, begin.cc:86-127),
        honoring the same component features as the stepping path."""
        if self.M > 0:
            return      # multistep primes lazily in _run_multistep
        coefs, accs, pots = self._project_and_accel(self._state, self.time)
        for n, ps in self._state.items():
            ps.acc, ps.pot = accs[n], pots[n]
        diag = {n: _diagnostics(ps) for n, ps in self._state.items()}
        self._capture_frozen(coefs)
        self._coefs, self._diag = self._to_host(coefs, diag)
        for o in self.outputs:
            o.run(self, self.istep, force=True)

    def _to_host(self, coefs, diag):
        host = _fetch({"c": coefs, "d": diag})
        return host["c"], host["d"]

    def _capture_frozen(self, coefs):
        """Record the initial coefficients of `self_consistent: false`
        components, in the compute dtype; every later step uses them in
        place of a projection of the live particles."""
        for n, c in self.components.items():
            if not c.self_consistent and n not in self._frozen:
                self._frozen[n] = coefs[n].to(self.compute_dtype)

    def run(self, nsteps=None):
        """Main loop (expand.cc:422-424)."""
        if self.M > 0:
            return self._run_multistep(nsteps)
        if self._coefs is None:
            self.prime()
        nsteps = self.nsteps if nsteps is None else nsteps
        k = max(1, self.steps_per_block)
        done = 0
        while done < nsteps:
            if self._check_stop():
                break
            kk = min(k, nsteps - done)
            # end blocks exactly on output-due steps: particle writers read
            # the state, which matches the labeled step only at block end
            dues = [o.nint - (self.istep % o.nint) for o in self.outputs
                    if o.nint > 0]
            if dues:
                kk = min(kk, min(dues))
            t0 = time.time()
            tcur = self.time
            for _ in range(kk):
                tcur = tcur + self.dt
                coefs, diag = self._step(tcur)
            t1 = time.time()
            self.timers["Compute"] += t1 - t0
            for _ in range(kk):
                self.istep += 1
                self.time += self.dt
                done += 1
                self._nreport_line()
            # the block's last step: one transfer of its coefficients and
            # diagnostics; only this step can be output-due
            self._coefs, self._diag = self._to_host(coefs, diag)
            t3 = time.time()
            for o in self.outputs:
                o.run(self, self.istep)
            self.timers["Output"] += time.time() - t3
            if self.verbose > 3:
                self._print_timings()
            self._check_bad_values()
            self._maybe_recompute_bases()
        return self._state

    def _nreport_line(self):
        """Progress report every nreport steps (reference nreport,
        global.H:56: per-step counter print)."""
        if self.nreport > 0 and self.istep % self.nreport == 0:
            wall = time.time() - self._wall0
            print(f"[exp_tpu_torch] step {self.istep}  time {self.time:.6g}  "
                  f"wall {wall:.1f}s", flush=True)

    def _maybe_recompute_bases(self, multistep=False):
        """Adaptive basis recomputation (Sphere::make_model* — Sphere.H:156,
        Sphere.cc:203-354): for sphereSL components with `dtime > 0`, rebuild
        the SL basis from the binned particle distribution every dtime."""
        from exp_tpu_torch.basis.model import model_from_particles

        for n, c in self.components.items():
            if c.basis_dtime <= 0 or self.time < c.basis_tnext:
                continue
            if multistep:
                self._sync_flat_state()
            ps = self._state[n]
            model = model_from_particles(_host(ps.x), _host(ps.mass))
            fc = c.config.force
            stanza = replace(fc, parameters={
                **{k: v for k, v in fc.parameters.items()
                   if k != "cachename"},
                "_model_object": model})
            c.force = build_force(stanza, self.compute_dtype, self.workdir,
                                  device=self.device)
            c.basis_tnext += c.basis_dtime
            if self._ms_runner is not None:
                self._ms_runner.forces[n] = c.force
            if self.verbose > 0:
                print(f"[exp_tpu_torch] recomputed {n!r} basis at "
                      f"t={self.time:g}")

    def _check_bad_values(self):
        """NaN guard (reference bad_values(), ComponentContainer.cc:1596;
        fpe_trap expand.cc:315-317): on non-finite diagnostics or
        coefficients, dump a diagnostic checkpoint and raise.  It runs after
        every block (every big step under multistep), so a blow-up is caught
        within `steps_per_block` steps of the faulting step.  `fpe: trace`
        runs this same guard (no PyTorch counterpart of jax_debug_nans)."""
        if not getattr(self.config.glob, "fpe", False) or self._diag is None:
            return

        def _dump_and_raise(n, what):
            from exp_tpu_torch.nbody.output import OutChkpt

            name = f"SPSCHK.{self.runtag}.badvalues"
            path = os.path.join(self.outdir, name)
            OutChkpt(self, nint=0, filename=name).run(self, self.istep,
                                                      force=True)
            raise FloatingPointError(
                f"non-finite {what} in component {n!r} at step "
                f"{self.istep}; state dumped to {path}")

        for n, d in self._diag.items():
            ke = float(_host(d["KE"]))
            pe = float(_host(d["PE"]))
            if not (np.isfinite(ke) and np.isfinite(pe)):
                _dump_and_raise(n, f"diagnostics (KE={ke}, PE={pe})")
        if self._coefs is not None:
            for n, c in self._coefs.items():
                if not np.isfinite(_host(c)).all():
                    _dump_and_raise(n, "coefficients")

    def _ms_sanity_check(self):
        """Diverging-run force stop (multistep.cc:296-341): if a component
        has more than maxMindt of its particles requesting a timestep below
        the finest level, checkpoint and stop."""
        max_mindt = float(getattr(self.config.glob, "maxMindt", 0.05))
        bad = []
        for n, (offlo, offhi, nlive) in self._ms_runner.overrun.items():
            if nlive > 0 and offlo / nlive > max_mindt:
                bad.append((n, offlo, nlive))
        if not bad:
            return
        for n, offlo, nlive in bad:
            print(f"[exp_tpu_torch] multistep overrun: component {n!r} has "
                  f"{offlo}/{nlive} ({100.0 * offlo / nlive:.1f}%) particles "
                  f"below the minimum timestep (> maxMindt="
                  f"{100 * max_mindt:.0f}%)")
        print("[exp_tpu_torch] stopping this run: decrease dtime, increase "
              "multistep, or both, and restart.  Writing a checkpoint.")
        self.stop_requested = True

    def _run_multistep(self, nsteps=None):
        """Multistep main loop: one big step per dtime, then the boundary
        relevel every `nrelevel` big steps (see nbody/multistep.py)."""
        nsteps = self.nsteps if nsteps is None else nsteps
        r = self._ms_runner
        if self._ms_state is None:
            st, regs, coef, diag = r.init_state(self._state, t0=self.time)
            self._ms_state, self._ms_regs = st, regs
            self._coefs, self._diag = self._to_host(coef, diag)
            self._sync_flat_state()
            for o in self.outputs:
                o.run(self, self.istep, force=True)
        for _ in range(nsteps):
            if self._check_stop():
                break
            t0 = time.time()
            st, regs, coef, diag = r.bigstep(self._ms_state, self._ms_regs,
                                             self.time)
            t1 = time.time()
            self.timers["Compute"] += t1 - t0
            if (self.istep + 1) % max(1, self.config.glob.nrelevel) == 0:
                st, regs = r.relevel(st, regs, t0=self.time + self.dt)
            t2 = time.time()
            self.timers["Relevel"] += t2 - t1
            self._ms_state, self._ms_regs = st, regs
            self.istep += 1
            self.time += self.dt
            self._nreport_line()
            if any(self.nint_due(o) for o in self.outputs):
                # one batched transfer of the coefficients and diagnostics
                self._coefs, self._diag = self._to_host(coef, diag)
                self._sync_flat_state()
            else:
                self._coefs, self._diag = coef, diag
            for o in self.outputs:
                o.run(self, self.istep)
            self.timers["Output"] += time.time() - t2
            self._ms_sanity_check()
            self._check_bad_values()
            self._maybe_recompute_bases(multistep=True)
            if self.verbose > 3:
                self._print_timings()
        self._sync_flat_state()
        return self._state

    def _print_timings(self):
        """Per-phase wall-clock percentages (step.cc:347-374 analogue)."""
        tot = sum(self.timers.values()) or 1.0
        parts = " ".join(f"{k}={v:.3f}s({100 * v / tot:.0f}%)"
                         for k, v in self.timers.items() if v > 0)
        print(f"[exp_tpu_torch] step {self.istep} timing: {parts}")

    def _check_stop(self):
        """Wall-clock budget / SIGTERM stop; SIGHUP checkpoint dump."""
        if self.dump_requested:
            self.dump_requested = False
            self._write_checkpoint()
        if self.stop_requested:
            self._write_checkpoint()
            return True
        if self.wall_limit is not None and \
                time.time() - self._wall0 > self.wall_limit:
            print(f"[exp_tpu_torch] wall-clock limit reached at step "
                  f"{self.istep}; checkpointing and stopping")
            self._write_checkpoint()
            if self.restart_cmd:
                import subprocess

                print(f"[exp_tpu_torch] launching restart_cmd: "
                      f"{self.restart_cmd}")
                subprocess.Popen(self.restart_cmd, shell=True)
            self.stop_requested = True
            return True
        return False

    def _write_checkpoint(self):
        from exp_tpu_torch.nbody.output import OutChkpt

        self._sync_flat_state()
        for o in self.outputs:
            if isinstance(o, OutChkpt):
                o.run(self, self.istep, force=True)
                return
        OutChkpt(self, nint=0).run(self, self.istep, force=True)

    def install_signal_handlers(self):
        """SIGTERM -> stop after the current block; SIGHUP -> checkpoint
        (the reference's signals.cc behavior)."""
        import signal

        def _term(sig, frame):
            print("[exp_tpu_torch] SIGTERM: stopping after current block")
            self.stop_requested = True

        def _hup(sig, frame):
            print("[exp_tpu_torch] SIGHUP: checkpoint requested")
            self.dump_requested = True

        signal.signal(signal.SIGTERM, _term)
        if hasattr(signal, "SIGHUP"):
            signal.signal(signal.SIGHUP, _hup)

    def nint_due(self, o):
        return o.nint > 0 and self.istep % o.nint == 0

    def _sync_flat_state(self):
        if self._ms_state is not None:
            self._state = {n: flatten_buckets(bs)
                           for n, bs in self._ms_state.items()}

    def host_ps(self, name):
        """Host copy of a component's particle state for the writers (NumPy
        arrays in a ParticleSystem), made once a step and shared by every
        writer due at it."""
        if self._host_cache_step.get(name) != self.istep:
            ps = self._state[name]
            self._host_cache[name] = ParticleSystem(
                **{f: _host(getattr(ps, f)) for f in _PS_FIELDS})
            self._host_cache_step[name] = self.istep
        return self._host_cache[name]

    # ------------------------------------------------------------------
    # outputs
    # ------------------------------------------------------------------

    def _make_output(self, oc):
        from exp_tpu_torch.nbody.output import (OrbTrace, OutAscii, OutCalbr,
                                                OutChkpt, OutCoef, OutDiag,
                                                OutFrac, OutHDF5, OutLog,
                                                OutMulti, OutPS, OutPSN,
                                                OutSamp, OutSPL, OutVel)

        if oc.id == "outchkptq":        # quick = single-precision variant
            return OutChkpt(self, real4=True, **oc.parameters)
        if oc.id in ("outpsq", "outpsr"):
            # reference split-piece writers with an nbeg dump counter
            # (src/OutPSQ.H:6-24, OutPSR.H); the piece count replaces
            # the MPI rank count, threads is an MPI-write knob → n/a
            p = dict(oc.parameters)
            p.pop("threads", None)
            p.setdefault("nbeg", 0)
            return OutSPL(self, **p)
        cls = {"outlog": OutLog, "outcoef": OutCoef, "outchkpt": OutChkpt,
               "outascii": OutAscii, "outpsn": OutPSN,
               "outmulti": OutMulti, "outvel": OutVel,
               "outsamp": OutSamp, "orbtrace": OrbTrace,
               "outdiag": OutDiag, "outfrac": OutFrac,
               "outcalbr": OutCalbr, "outps": OutPS,
               "outhdf5": OutHDF5, "outpsp": OutSPL,
               "outspl": OutSPL}.get(oc.id)
        if cls is None:
            raise ConfigError(f"output id {oc.id!r} not implemented yet")
        return cls(self, **oc.parameters)

    def total_diag(self):
        """Sum per-component diagnostics to global values (host)."""
        tot = {}
        for n, d in self._diag.items():
            for key, val in d.items():
                tot[key] = tot.get(key, 0.0) + _host(val)
        return tot

    @classmethod
    def from_file(cls, path, **kw):
        cfg = RunConfig.from_file(path)
        return cls(cfg, workdir=os.path.dirname(os.path.abspath(path)), **kw)
