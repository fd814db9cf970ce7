"""Simulation driver: config -> components -> run loop (port of
exp_tpu/nbody/simulation.py), on one device or on each rank of a World.

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

The component extras run on both paths as in exp_tpu: EJ center and axis
tracking with its orient log, nEJaccel's frame correction and a
centerfile (nbody/centering.py); coefficient playback from a file
(analysis/coefs.py) and NOISE draws (nbody/noise.py); Hall/PCA smoothing
(npca, nbody/pca.py); the sphere and polar harmonic restrictions and
FIX_L0; the External stanza's fields, PeriodicBC and host operators
(forces/external.py; the operators between blocks of the single-rate path
only); and `self_consistent: false`, whose frozen coefficients ride the
playback channel.  A tracked rotation multiplies positions by a three-term
sum, never a matrix product that TF32 would round on the card; a
component with no tracked center or rotation skips both.

Every force id of exp_tpu's factory is built.  A two-center force's
coefficients are a pair, carried by `tmap` through the runner, and the
host transfer, the NaN guard and OutCoef take the pair as exp_tpu's
tree_map does; a source (direct) component's coefficients are a (1,)
zero, and the components it couples to read its positions and masses.

On a World of several ranks (parallel/distributed.py; run.py
`--distributed` or `--ndev k`) each rank reads its row block of every body
file and steps its own rows; coefficients, centers, diagnostics and level
counts are summed over the ranks; rank 0 builds the basis tables and
broadcasts them; the writers gather phase space on every rank and write
once, from rank 0 (every writer, the orient logs; OutSamp and OutVel sum
each rank's projections instead of gathering), and a restart reads the
checkpoint by row block.  The stop decision (wall clock, signals) is
agreed by all ranks before a block.  EJ's most-bound set is a global top
k of the ranks' candidates; Hall/PCA and OutSamp subsample by global row.
The host operators see the global state in the one-rank run's row order
(the world's zero-mass padding rows left out): every rank gathers it,
applies them with the same seeded draws and keeps its own rows, and
generateRelaxation writes from rank 0.  The adaptive basis rebuild
(sphereSL `dtime`) gathers the state, builds the model from the binned
particles and the SL tables on rank 0 and broadcasts them.
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
from exp_tpu_torch.nbody.multistep import (_NO_EXTRAS, CompFeats, _accel_at,
                                           _add_externals, _assemble_extras,
                                           _com_centers, _eff_forces,
                                           _project, _project_tc,
                                           _pseudo_accel, flatten_buckets,
                                           rotate, source_names)
from exp_tpu_torch.nbody.particles import ParticleSystem, _host, read_bodies
from exp_tpu_torch.nbody.step import _diagnostics
from exp_tpu_torch.parallel.distributed import (all_reduce, allgather_ps,
                                                current_world, primary_build,
                                                row_block, sum_host)

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
    """A nested dict (or tuple) of tensors as the same structure of NumPy
    arrays, in one device-to-host transfer: every leaf flattened into one
    f64 buffer (complex leaves as their (re, im) pairs), then cut and cast
    back to its dtype (exact: f32 -> f64 -> f32 rounds nothing)."""
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, tuple):
            for v in t:
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
        if isinstance(t, tuple):
            return tuple(build(v) for v in t)
        return next(it)

    return build(tree)


# ---------------------------------------------------------------------------
# Force factory
# ---------------------------------------------------------------------------

def build_force(fc, dtype, workdir=".", particles=None, device=None,
                world=None):
    """Instantiate a force from its config stanza (host-side table builds)
    on `device` (None: CUDA, raising when there is none).  The force keeps
    that device as its `device` attribute, which a force without tables
    (shells, direct) has no other way to tell.

    `particles`: optional (x, mass) host arrays of the owning component,
    used when a basis conditions on the snapshot itself (cylinder
    `conditioning: particles`, the reference's accumulate_eof path).
    `world`: on a World of several ranks the SL, EOF and slab tables are
    built on rank 0 and broadcast."""
    device = resolve_device(device)
    force = _build_force(fc, dtype, workdir, particles, device, world)
    force.device = device
    return force


def _build_force(fc, dtype, workdir, particles, device, world):
    p = dict(fc.parameters)
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
                                cmap=cmap, rmap=rmap, cachename=cachename,
                                world=world)
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
            cachename=cachename, world=world)
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
            cachename=cachename, world=world)
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
            cachename=cachename, world=world)
        return SlabForce.from_tables(
            t, dtype=dtype, backend=str(p.pop("backend", "einsum")),
            device=device)
    elif fc.id == "bessel":
        from exp_tpu_torch.basis.bessel import make_bessel_force

        return make_bessel_force(
            lmax=int(p.pop("Lmax", p.pop("lmax", 4))),
            nmax=int(p.pop("nmax", 10)),
            rmax=float(p.pop("rmax", 1.0)),
            numr=int(p.pop("numr", 2000)), dtype=dtype, device=device)
    elif fc.id in ("CBsphere", "hernq"):
        from exp_tpu_torch.basis.analytic import make_analytic_force

        return make_analytic_force(
            fc.id, lmax=int(p.pop("Lmax", p.pop("lmax", 4))),
            nmax=int(p.pop("nmax", 10)),
            rmin=float(p.pop("rmin", 1e-3)),
            rmax=float(p.pop("rmax", 50.0)),
            numr=int(p.pop("numr", 2000)),
            scale=float(p.pop("scale", 1.0)), dtype=dtype,
            backend=str(p.pop("backend", "matmul")), device=device)
    elif fc.id == "direct":
        from exp_tpu_torch.forces.direct import DirectForce

        # reference defaults to the SplineSoft kernel when `type` is
        # absent (src/Direct.cc:88-93)
        kernel = str(p.pop("type", "Spline")).lower()
        kw = dict(eps=float(p.pop("soft", p.pop("eps", 1e-4))),
                  kernel="spline" if kernel.startswith("spline")
                  else "plummer",
                  mn_model=bool(p.pop("mn_model", False)),
                  a=float(p.pop("a", 1.0)), b=float(p.pop("b", 0.1)))
        if p.pop("pm_model", False):
            from exp_tpu_torch.basis.model import SphericalModelTable

            # the path as given, as exp_tpu reads it (not under workdir)
            model = SphericalModelTable.from_file(
                str(p.pop("pmmodel_file", "SLGridSph.model")))
            return DirectForce.with_pm_model(model, device=device, **kw)
        return DirectForce(**kw).to(device)
    elif fc.id == "shells":
        from exp_tpu_torch.forces.shells import ShellsForce

        return ShellsForce(rmax=float(p.pop("rmax", 10.0)),
                           nbins=int(p.pop("nbins", 256)))
    elif fc.id == "halobulge":
        from exp_tpu_torch.basis.model import SphericalModelTable
        from exp_tpu_torch.forces.shells import HaloBulgeForce

        model = SphericalModelTable.from_file(
            os.path.join(workdir, p.pop("modelname")))
        return HaloBulgeForce.from_model(model, dtype=dtype, device=device)
    elif fc.id == "twocenter":
        from exp_tpu_torch.config import ForceConfig
        from exp_tpu_torch.forces.twocenter import TwoCenterForce

        cfac = float(p.pop("cfac", 1.0))
        alpha = float(p.pop("alpha", 1.0))
        inner_cfg = p.pop("inner", None)
        outer_cfg = p.pop("outer", None)
        base_id = p.pop("basis", "sphereSL")
        base_params = p.pop("parameters", dict(p))

        def mk(cfg):
            if cfg is None:
                cfg = {"id": base_id, "parameters": base_params}
            return build_force(
                ForceConfig(id=cfg.get("id", base_id),
                            parameters=dict(cfg.get("parameters",
                                                    base_params))),
                dtype, workdir, particles=particles, device=device,
                world=world)

        zero = torch.zeros(3, dtype=dtype, device=device)
        return TwoCenterForce(inner=mk(inner_cfg), outer=mk(outer_cfg),
                              c1=zero, c2=zero, cfac=cfac, alpha=alpha)
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
    # EJ center/axis tracking (Orient); ej_flags is the reference bitmask
    # (AXIS=1, CENTER=2, Orient.H:129)
    EJ: bool = False
    ej_flags: int = 0
    orient: object = None
    # prescribed center trajectory (CenterFile)
    center_traj: object = None
    # non-inertial expansion-frame correction (include/PseudoAccel.H;
    # Component.cc:4407-4425), enabled by `nEJaccel > 0`: subtracted from
    # self-gravity (AddAcc) but not from externals (AddAccExt)
    pseudo: object = None
    # coefficient playback (a Coefs series or NOISE draws) / Hall smoothing
    # (AxisymmetricBasis.H:20-43)
    playback: object = None
    npca: int = 0
    nsamples: int = 8
    tk_type: str = "Hall"
    tksmooth: float = 3.0
    tkcum: float = 0.95
    # smooth in the subsample-covariance eigenbasis instead of channel-wise
    # (AxisymmetricBasis.H:27 pcaeof)
    pcaeof: bool = False

    @property
    def feats(self) -> CompFeats:
        return CompFeats(adiabatic=self.adiabatic, ton=self.ton,
                         twid=self.twid, rtrunc=self.rtrunc,
                         com_system=self.com_system)


def _check_world(world):
    """Refuse a process group of several ranks that `world` does not span:
    each rank would step the whole system alone and write every file."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return
    n = dist.get_world_size()
    if n > 1 and (world is None or world.size < n):
        raise RuntimeError(
            f"a process group of {n} ranks is up, but the run was given "
            f"{'no World' if world is None else f'a World of {world.size}'}"
            ": join it with parallel.init_distributed (or pass its World) "
            "so that no rank runs alone")


class Simulation:
    """Multi-component BFE N-body run on one device (None: CUDA, raising
    when there is none), or on this rank's rows of a World (`world`;
    default: the world `init_distributed` joined, if any), on the rank's
    device."""

    def __init__(self, config: RunConfig, workdir=".", device=None,
                 steps_per_block: int | None = None, world=None):
        world = world if world is not None else current_world()
        _check_world(world)
        #: a world of several ranks; None on one device
        self.world = world if world is not None and world.size > 1 else None
        self.dist = self.world is not None
        self.is_primary = not self.dist or self.world.is_primary
        self.config = config
        self.workdir = workdir
        self.device = (self.world.device if self.dist
                       else resolve_device(device))
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
        if self.is_primary:
            os.makedirs(self.outdir, exist_ok=True)
        self.time = 0.0
        self.istep = 0
        self.compute_dtype = _torch_dtype(g.compute_dtype)
        self.accum_dtype = _torch_dtype(g.accum_dtype)

        # components
        self.components: dict[str, Component] = {}
        #: on a world: each component's global row count without the
        #: zero-mass padding rows (the body file's, or the checkpoint's)
        self._nrows: dict[str, int] = {}
        #: each adaptive rebuild: its component, time and the kernel
        #: launch counts when it ran (run.py --launches reports them)
        self.rebuilds: list[dict] = []
        #: harmonic-restriction state per component: {"mask": 0/1 array over
        #: the coefficient layout, "fix_l0": bool, "c0": captured monopole}
        self._restrict: dict[str, dict] = {}
        for cc in config.components:
            if cc.bodyfile is None:
                raise ConfigError(f"component {cc.name}: no bodyfile")
            cp = cc.parameters or {}
            # bodyfile may be reference ascii OR a PSP binary snapshot
            # (sniffed by magic) — the name inside a multi-component PSP
            # defaults to this component's name
            if self.dist:
                # each rank parses only its row block (Component.H:202-204)
                from exp_tpu_torch.parallel.distributed import (
                    read_bodies_distributed)

                ps, self._nrows[cc.name] = read_bodies_distributed(
                    os.path.join(workdir, cc.bodyfile), self.world,
                    dtype=self.compute_dtype,
                    component=cp.get("psp_component", cc.name),
                    scale_dattr=cp.get("scale_dattr"), with_rows=True)
            else:
                ps = read_bodies(os.path.join(workdir, cc.bodyfile),
                                 dtype=self.compute_dtype,
                                 component=cp.get("psp_component", cc.name),
                                 scale_dattr=cp.get("scale_dattr"),
                                 device=self.device)
            n_global = int(sum_host(np.array([ps.n], np.int64), self.world)[0])
            if g.nbodmax and n_global > g.nbodmax:
                raise ConfigError(
                    f"component {cc.name}: {n_global} bodies exceeds "
                    f"nbodmax={g.nbodmax}")
            cond = None
            if (cc.force.id == "cylinder" and (cc.force.parameters or {})
                    .get("conditioning") == "particles"):
                hp = allgather_ps(ps, self.world)
                cond = (hp.x, hp.mass)
            force = build_force(cc.force, self.compute_dtype, workdir,
                                particles=cond, device=self.device,
                                world=self.world)
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
            self._component_extras(c0, cc, workdir)
        self._centers = {n: np.zeros(3) for n in self.components}
        self._rots = {n: np.eye(3) for n in self.components}
        # restart: resume orient-tracked centers/rotations immediately
        for n, c in self.components.items():
            if c.orient is not None and len(c.orient._histC):
                if c.ej_flags & 2:
                    self._centers[n] = c.orient.center
                if c.ej_flags & 1:
                    self._rots[n] = c.orient.body
        self._hall = {}          # name -> smoothing weights on the device
        #: frozen coefficient sets for `self_consistent: false` components
        #: (captured from the initial projection, in the compute dtype, and
        #: injected through the playback channel: the expansion never
        #: responds to the live particles — the reference's fixed-potential
        #: component)
        self._frozen = {}
        for n, c in self.components.items():
            src = (getattr(c.force, "needs_sources", False)
                   or getattr(c.force, "needs_centers", False))
            if not c.self_consistent and src:
                raise ConfigError(
                    f"component {n}: self_consistent: false is only "
                    f"supported for coefficient-based forces")
            if c.npca > 0 and src:
                raise ConfigError(
                    f"component {n}: npca smoothing needs an array-valued "
                    f"coefficient basis (AxisymmetricBasis PCA)")
            if (c.ej_flags & 1) and getattr(c.force, "needs_centers", False):
                raise ConfigError(
                    f"component {n}: EJ AXIS tracking is not supported "
                    f"with a twocenter force (the two-center blend is "
                    f"evaluated in the inertial frame); use EJ: 2 "
                    f"(CENTER) only")

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

        # external fields + boundary wrappers + host operators (External:)
        from exp_tpu_torch.forces.external import (PeriodicBC, build_external,
                                                   build_operator)

        self.externals = []
        self.wrappers = []
        self.operators = []      # host operators between blocks
        for e in (config.external or []):
            if not e:
                continue
            if e.get("id") == "periodicBC":
                self.wrappers.append(PeriodicBC(
                    **(e.get("parameters") or {})))
                continue
            op = build_operator(e, runtag=config.glob.runtag,
                                outdir=self.outdir,
                                seed=getattr(g, "random_seed", None),
                                primary=self.is_primary)
            if op is not None:
                self.operators.append(op)
            else:
                self.externals.append(build_external(
                    e, workdir=workdir, dtype=self.compute_dtype,
                    device=self.device))

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
        # playback coefficients / prescribed centers are interpolated on the
        # host per block; a block must then be ONE step or the run would
        # integrate against stale fields mid-block (the reference
        # interpolates them every step)
        if steps_per_block is None and any(
                c.playback is not None or c.center_traj is not None
                for c in self.components.values()):
            self.steps_per_block = 1

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
        self.timers = {k: 0.0 for k in
                       ("Compute", "Orient", "Hall", "Output", "Relevel")}
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

            self._ms_runner = MultistepRunner(
                {n: c.force for n, c in self.components.items()},
                self.couples, self.dt, self.M, accum_dtype=self.accum_dtype,
                dynparams={"dynfracV": g.dynfracV, "dynfracA": g.dynfracA,
                           "dynfracP": g.dynfracP, "dynfracD": g.dynfracD,
                           "dynfracS": g.dynfracS},
                shiftlevl=g.shiftlevl,
                feats={n: c.feats for n, c in self.components.items()},
                fused=g.fused_bigstep, cap_headroom=g.cap_headroom,
                eqmotion=self.eqmotion, externals=self.externals,
                wrappers=self.wrappers, world=self.world)

    def _component_extras(self, c, cc, workdir):
        """A component's EJ/nEJaccel/centerfile tracking, playback or NOISE
        source, harmonic restriction and smoothing settings, from its
        component and force parameters (exp_tpu's Simulation.__init__)."""
        g = self.config.glob
        cp = cc.parameters or {}
        # EJ is the reference's orient bitmask (Orient.H:129: AXIS=1,
        # CENTER=2); a bare `EJ: true` means center tracking
        ejraw = cp.get("EJ", 0)
        c.ej_flags = 2 if ejraw is True else int(ejraw or 0)
        c.EJ = bool(c.ej_flags)
        # nEJaccel > 0 enables the non-inertial frame correction
        # (Component.cc:1355 Orient ctor Naccel; PseudoAccel.H)
        naccel = int(cp.get("nEJaccel", 0))
        if naccel > 0:
            from exp_tpu_torch.nbody.centering import PseudoAccel

            c.pseudo = PseudoAccel(
                nsize=naccel,
                center=bool(c.ej_flags & 2) or bool(cp.get("centerfile")),
                axis=bool(c.ej_flags & 1))
        if c.ej_flags:
            from exp_tpu_torch.nbody.centering import EJOrient

            logf = os.path.join(self.outdir, f"{g.runtag}.orient.{cc.name}")
            # nEJkeep 256 and EJwindow 16 as exp_tpu's code has them
            c.orient = EJOrient(nkeep=int(cp.get("nEJkeep", 256)),
                                window=int(cp.get("EJwindow", 16)),
                                damp=float(cp.get("EJdamp", 1.0)),
                                logfile=logf, pseudo=c.pseudo,
                                write_log=self.is_primary)
            if g.infile and os.path.exists(logf):
                # restart: reload the regression history
                c.orient.load_log(logf)
        if cp.get("centerfile"):
            from exp_tpu_torch.nbody.centering import CenterFile

            c.center_traj = CenterFile(os.path.join(workdir,
                                                    cp["centerfile"]))
        # coefficient playback (the reference's play_back,
        # SphericalBasis.cc determine_coefficients_playback)
        if cp.get("playback"):
            from exp_tpu_torch.analysis.coefs import Coefs

            c.playback = Coefs.from_file(os.path.join(workdir,
                                                      cp["playback"]))
        # coefficient NOISE experiment (SphericalBasis.cc:2109-2214),
        # delivered through the playback channel
        fp = cc.force.parameters or {}
        if fp.get("NOISE") and cc.force.id in ("sphereSL", "bessel"):
            from exp_tpu_torch.nbody.noise import SphereNoise

            nmf = str(fp.get("noise_model_file",
                             fp.get("modelname", "SLGridSph.model")))
            nmp = os.path.join(workdir, nmf)
            if os.path.exists(nmp):
                from exp_tpu_torch.basis.model import SphericalModelTable

                nmodel = SphericalModelTable.from_file(nmp)
            else:
                from exp_tpu_torch.cli._common import load_model

                nmodel = load_model(nmf)
            c.playback = SphereNoise.build(
                c.force, nmodel, noiseN=float(fp.get("noiseN", 1.0e-6)),
                seedN=int(fp.get("seedN", 11)))
        # harmonic restrictions (SphericalBasis valid_keys,
        # SphericalBasis.cc:33-39; applied in the force loop :1568-1600,
        # FIX_L0 :1689-1694): a 0/1 mask over the coefficient array — the
        # force is linear in the coefficients, so masking them equals
        # skipping terms
        if cc.force.id in ("sphereSL", "bessel") and any(
                fp.get(k) for k in _SPHERE_RESTRICT):
            L, nm = c.force.lmax, c.force.nmax
            mask = np.ones((2, L + 1, L + 1, nm), np.float32)
            if fp.get("NO_L0"):
                mask[:, 0] = 0.0
            if fp.get("NO_L1") and L >= 1:
                mask[:, 1] = 0.0
            if fp.get("EVEN_L"):
                mask[:, np.arange(L + 1) % 2 == 1] = 0.0
            if fp.get("EVEN_M"):
                mask[:, :, np.arange(L + 1) % 2 == 1] = 0.0
            if fp.get("M0_ONLY"):
                mask[:, :, 1:] = 0.0
            self._restrict[cc.name] = {
                "mask": mask, "fix_l0": bool(fp.get("FIX_L0")), "c0": None}
        # polar/cylinder analogues (PolarBasis.cc:36-45; Cylinder.cc
        # valid_keys) over the (2, mmax+1, nmax) coefficient layout
        if cc.force.id in ("cylinder", "flatdisk", "CBDisk") and any(
                fp.get(k) is not None and fp.get(k) is not False
                for k in _POLAR_RESTRICT):
            Mm, nm = c.force.mmax, c.force.nmax
            mask = np.ones((2, Mm + 1, nm), np.float32)
            if fp.get("NO_M0"):
                mask[:, 0] = 0.0
            if fp.get("NO_M1") and Mm >= 1:
                mask[:, 1] = 0.0
            if fp.get("EVEN_M"):
                mask[:, np.arange(Mm + 1) % 2 == 1] = 0.0
            if fp.get("M0_ONLY"):
                mask[:, 1:] = 0.0
            if fp.get("mlim") is not None:
                mask[:, int(fp["mlim"]) + 1:] = 0.0
            self._restrict[cc.name] = {
                "mask": mask, "fix_l0": False, "c0": None}
        # coefficient smoothing (npca/nsamples/tk_type knobs,
        # AxisymmetricBasis.H:20-43)
        c.npca = int(cp.get("npca", 0))
        c.nsamples = int(cp.get("nsamples", 8))
        c.tk_type = str(cp.get("tk_type", "Hall"))
        c.tksmooth = float(cp.get("tksmooth", 3.0))
        c.tkcum = float(cp.get("tkcum", 0.95))
        c.pcaeof = bool(cp.get("pcaeof", False))

    # ------------------------------------------------------------------
    # stepping
    # ------------------------------------------------------------------

    def _project_and_accel(self, state, t, centers=None, extras=None,
                           rots=None):
        """Per-component projection + acceleration: coefficients with the
        adiabatic ramp, rtrunc, centers, rotations, playback, Hall and the
        restriction applied, then every component's acceleration and
        potential from the coupled fields, the frame correction and the
        external fields — shared by the step and the initial prime so that
        features are honored identically in both (reference: the same
        determine_coefficients path for begin_run and do_step).

        `centers` and `rots` map a component to its tracked center and
        body-frame rotation, None for the origin and the identity."""
        ex = extras or _NO_EXTRAS
        feats = {n: self.components[n].feats for n in state}
        forces = {n: c.force for n, c in self.components.items()}
        centers = centers or {}
        rots = rots or {n: None for n in state}
        world = self.world
        bs = {n: [ps] for n, ps in state.items()}
        ctr = _com_centers(bs, feats, centers, world)
        # two-center forces: inner = the resolved center, outer = the COM
        eff, tc = _eff_forces(forces, bs, ctr, world)
        src = source_names(forces)
        coefs = {}
        for n, ps in state.items():
            if n in ex["playback"]:
                cf = ex["playback"][n]
                if n in ex["restrict"]:
                    mk, off = ex["restrict"][n]
                    cf = cf * mk + off
                coefs[n] = cf
            elif n in src:
                coefs[n] = torch.zeros((1,), dtype=ps.x.dtype,
                                       device=ps.x.device)
            elif n in tc:
                coefs[n] = _assemble_extras(n, _project_tc(
                    eff[n], feats[n], ps.x, ps.mass, t, ctr[n],
                    self.accum_dtype, world), ex)
            else:
                coefs[n] = _assemble_extras(n, _project(
                    forces[n], feats[n], ps.x, ps.mass, t, ctr[n],
                    self.accum_dtype, rot=rots[n], world=world), ex)
        srcs = {n: (state[n].x, state[n].mass) for n in src}
        accs, pots = {}, {}
        for n, ps in state.items():
            acc, pot = _accel_at(ps.x, t, self.couples[n], eff, coefs,
                                 ctr, rots, cast=False, tc=tc, sources=srcs,
                                 world=world)
            # non-inertial expansion-frame correction: subtracted from
            # self-gravity (AddAcc, Component.H:913-921) BEFORE externals
            # are added (AddAccExt applies no correction)
            if n in ex["pseudo"]:
                acc = acc - _pseudo_accel(ex["pseudo"][n], ps.x, ps.v,
                                          ctr[n])
            accs[n], pots[n] = _add_externals(acc, pot, ps.x, t,
                                              self.externals)
        return coefs, accs, pots

    def _step(self, t_new, centers, extras, rots):
        """One KDK step of every component, in place; t_new is the time at
        the end of the step.  Returns (coefs, diag) on the device."""
        # eqmotion: false freezes x/v (reference incpos.cc:75/incvel.cc:93
        # return early) while the field evaluation below still runs
        dt = self.dt if self.eqmotion else 0.0
        for ps in self._state.values():
            ps.v.add_(ps.acc * (dt * 0.5))          # half kick
            ps.x.add_(ps.v * dt)                    # drift
            for wrp in self.wrappers:
                ps.x = wrp.wrap(ps.x)
        coefs, accs, pots = self._project_and_accel(self._state, t_new,
                                                    centers, extras, rots)
        for n, ps in self._state.items():
            ps.v.add_(accs[n] * (dt * 0.5))         # half kick
            ps.acc, ps.pot = accs[n], pots[n]
        return coefs, {n: _diagnostics(ps, self.world)
                       for n, ps in self._state.items()}

    def prime(self):
        """Initial coefficient/force evaluation (begin_run, begin.cc:86-127),
        honoring the same component features as the stepping path."""
        if self.M > 0:
            return      # multistep primes lazily in _run_multistep
        extras = self._make_extras(t=self.time)
        self._refresh_centerfile()
        coefs, accs, pots = self._project_and_accel(
            self._state, self.time, self._center_arrays(), extras,
            self._rot_arrays())
        for n, ps in self._state.items():
            ps.acc, ps.pot = accs[n], pots[n]
        diag = {n: _diagnostics(ps, self.world)
                for n, ps in self._state.items()}
        self._capture_frozen(coefs)
        self._coefs, self._diag = self._to_host(coefs, diag)
        for o in self.outputs:
            o.run(self, self.istep, force=True)

    def _to_host(self, coefs, diag):
        host = _fetch({"c": coefs, "d": diag})
        return host["c"], host["d"]

    def _capture_frozen(self, coefs):
        """Record the initial coefficients of `self_consistent: false`
        components, in the compute dtype; every later step reads them back
        through the playback channel in place of a projection of the live
        particles.  FIX_L0: save the monopole of the first evaluation
        (SphericalBasis.cc:1689-1694), on the host."""
        for n, c in self.components.items():
            if not c.self_consistent and n not in self._frozen:
                self._frozen[n] = coefs[n].to(self.compute_dtype)
        for n, r in self._restrict.items():
            if r["fix_l0"] and r["c0"] is None and n in coefs:
                r["c0"] = _host(coefs[n])[:, 0, 0, :].copy()

    def _restrict_arrays(self):
        """(mask, offset) per restricted component, in the accumulation
        dtype: coefficients are consumed as `c * mask + offset`."""
        out = {}
        for n, r in self._restrict.items():
            mk = r["mask"]
            # f64 staging: a float32 offset would round the captured
            # monopole before the accum-dtype cast
            off = np.zeros(mk.shape, np.float64)
            if r["fix_l0"] and r["c0"] is not None:
                mk = mk.copy()
                mk[:, 0, 0, :] = 0.0
                off[:, 0, 0, :] = r["c0"]
            out[n] = tuple(torch.as_tensor(a, dtype=self.accum_dtype,
                                           device=self.device)
                           for a in (mk, off))
        return out

    def _refresh_centerfile(self):
        """Evaluate prescribed (CenterFile) centers at the current time and
        feed the frame-acceleration estimator when enabled (the EJ path
        feeds it from orient.update instead, Orient.cc:697)."""
        for n, c in self.components.items():
            if c.center_traj is None:
                continue
            self._centers[n] = c.center_traj(self.time)
            if c.pseudo is not None and c.orient is None:
                c.pseudo.add(self.time, self._centers[n])

    def _pseudo_arrays(self):
        """(accel, omega, domdt) per pseudo-enabled component."""
        out = {}
        for n, c in self.components.items():
            if c.pseudo is None:
                continue
            out[n] = tuple(torch.as_tensor(a, dtype=self.compute_dtype,
                                           device=self.device)
                           for a in c.pseudo())
        return out

    def _center_arrays(self):
        """Tracked (EJ CENTER or centerfile) expansion centers as tensors;
        None for a component whose center is the origin."""
        out = {}
        for n, c in self.components.items():
            tracked = (c.center_traj is not None
                       or (c.orient is not None and c.ej_flags & 2))
            out[n] = (torch.as_tensor(self._centers[n],
                                      dtype=self.compute_dtype,
                                      device=self.device)
                      if tracked else None)
        return out

    def _rot_arrays(self):
        """Body-frame rotations of EJ AXIS components as tensors; None for
        the identity."""
        return {n: (torch.as_tensor(self._rots[n], dtype=self.compute_dtype,
                                    device=self.device)
                    if c.orient is not None and c.ej_flags & 1 else None)
                for n, c in self.components.items()}

    def _ms_centers(self):
        """Prescribed expansion centers for the multistep path (EJ orient /
        centerfile); com_system centers are computed by the runner."""
        self._refresh_centerfile()
        return self._center_arrays()

    def _make_extras(self, t=None):
        """Extras of a block (or a substep, at time t): playback
        coefficients interpolated in float64 on the host at the end-of-step
        time by default and cast to the compute dtype (frozen sets for
        `self_consistent: false`), the Hall weights in the compute dtype,
        the restriction and the frame correction."""
        pb, hall = {}, {}
        for n, c in self.components.items():
            if c.playback is not None:
                # coefficients apply to the DRIFTED positions: interpolate at
                # the end-of-step time (blocks are one step under playback)
                pb[n] = torch.as_tensor(
                    c.playback.interpolate(self.time + self.dt if t is None
                                           else t),
                    dtype=self.compute_dtype, device=self.device)
            elif n in self._frozen:
                pb[n] = self._frozen[n]
            if n in self._hall:
                hall[n] = self._hall[n].to(self.compute_dtype)
        return {"playback": pb, "hall": hall,
                "restrict": self._restrict_arrays(),
                "pseudo": self._pseudo_arrays()}

    def _update_orient(self, multistep=False):
        """EJ Orient update: center (flag CENTER=2) and axis frame (flag
        AXIS=1) per block/big step (src/Orient.cc; Component.H:775), from
        the state on its device."""
        for n, c in self.components.items():
            if not (c.EJ and c.orient is not None):
                continue
            if multistep:
                self._sync_flat_state()
            c.orient.update(self._state[n], time=self.time, world=self.world)
            if c.ej_flags & 2:
                self._centers[n] = c.orient.center
            if c.ej_flags & 1:
                self._rots[n] = c.orient.body

    def _update_hall(self, multistep=False):
        """Recompute coefficient smoothing weights every npca steps
        (pca_hall analogue; tk_type selects Hall/VarianceCut/CumulativeCut/
        VarianceWeighted per AxisymmetricBasis.cc:482-503).  The state stays
        on its device: `nsamples` projections of the component's own
        coefficients on round-robin masked masses, in the same frame and
        weighting as the stepping path (center, body rotation, adiabatic
        ramp, rtrunc)."""
        from exp_tpu_torch.nbody.pca import (_mean_var, eof_smoothing_matrix,
                                             smoothing_weights,
                                             subsample_coefficients)

        for n, c in self.components.items():
            if not (c.npca > 0 and self.istep % c.npca == 0):
                continue
            if multistep:
                self._sync_flat_state()
            ps = self._state[n]
            x, m = ps.x, ps.mass
            center = self._center_arrays()[n]
            if c.com_system:
                live = (m > 0).to(m.dtype)
                mx = all_reduce(torch.cat([
                    torch.sum((m * live)[:, None] * x, dim=0),
                    torch.sum(m * live).reshape(1)]), self.world)
                center = mx[:3] / torch.clamp(mx[3], min=1e-300)
            xc = x if center is None else x - center.to(x.dtype)[None, :]
            rot = self._rot_arrays()[n]
            if rot is not None:
                xc = rotate(xc, rot.to(x.dtype))
            mw = m * float(c.feats.adb(self.time))
            if c.rtrunc < 1.0e19:
                mw = mw * (torch.sum(xc * xc, dim=-1)
                           < c.rtrunc ** 2).to(mw.dtype)
            cs = subsample_coefficients(c.force, xc, mw,
                                        nsamples=c.nsamples,
                                        accum_dtype=self.accum_dtype,
                                        world=self.world)
            if c.pcaeof:
                self._hall[n] = torch.as_tensor(
                    eof_smoothing_matrix(cs, tk_type=c.tk_type,
                                         tksmooth=c.tksmooth, tkcum=c.tkcum),
                    dtype=cs.dtype, device=cs.device)
                continue
            mean, var = _mean_var(cs)
            self._hall[n] = smoothing_weights(mean, var, tk_type=c.tk_type,
                                              tksmooth=c.tksmooth,
                                              tkcum=c.tkcum)

    def _block_end_updates(self, multistep=False):
        """Orient, then Hall, at block (big step) end, after the counters
        advance and before the writes."""
        t2 = time.time()
        self._update_orient(multistep)
        t3 = time.time()
        self.timers["Orient"] += t3 - t2
        self._update_hall(multistep)
        self.timers["Hall"] += time.time() - t3

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
            extras = self._make_extras()
            self._refresh_centerfile()
            centers, rots = self._center_arrays(), self._rot_arrays()
            t0 = time.time()
            tcur = self.time
            for _ in range(kk):
                tcur = tcur + self.dt
                coefs, diag = self._step(tcur, centers, extras, rots)
            t1 = time.time()
            self.timers["Compute"] += t1 - t0
            for _ in range(kk):
                self.istep += 1
                self.time += self.dt
                done += 1
                self._nreport_line()
            self._block_end_updates()
            # the block's last step: one transfer of its coefficients and
            # diagnostics; only this step can be output-due
            self._coefs, self._diag = self._to_host(coefs, diag)
            t3 = time.time()
            for o in self.outputs:
                o.run(self, self.istep)
            self.timers["Output"] += time.time() - t3
            # host operators (scatterMFP, generateRelaxation): applied once
            # a block, between blocks
            if self.operators:
                self._apply_operators(self.dt * kk)
                # writers at this istep cached the pre-operator state; a
                # stop/SIGHUP checkpoint after this point must see the kicks
                self._host_cache_step.clear()
            if self.verbose > 3:
                self._print_timings()
            self._check_bad_values()
            self._maybe_recompute_bases()
        return self._state

    def _apply_operators(self, dt):
        """Each host operator on each component, in that order.  On a world
        every rank gathers each component's global state (its first
        `_nrows` rows: the one-rank run's rows, in its order), applies the
        operators there with the same seeded draws as every other rank, and
        keeps the positions and velocities of its own row block."""
        if not self.dist:
            for op in self.operators:
                for n in self._state:
                    self._state[n] = op.apply(self._state[n], dt, self.istep,
                                              time=self.time, name=n)
            return
        glob = {}
        for n, ps in self._state.items():
            hp = allgather_ps(ps, self.world)
            k = self._nrows[n]
            glob[n] = ParticleSystem(**{
                f: torch.as_tensor(getattr(hp, f)[:k]) for f in _PS_FIELDS})
        for op in self.operators:
            for n in glob:
                glob[n] = op.apply(glob[n], dt, self.istep, time=self.time,
                                   name=n)
        for n, ps in self._state.items():
            lo, hi = row_block(ps.n * self.world.size, self.world)
            k = max(0, min(hi, self._nrows[n]) - lo)
            x, v = ps.x.clone(), ps.v.clone()
            x[:k] = glob[n].x[lo:lo + k].to(x.device, x.dtype)
            v[:k] = glob[n].v[lo:lo + k].to(v.device, v.dtype)
            self._state[n] = replace(ps, x=x, v=v)

    def _nreport_line(self):
        """Progress report every nreport steps (reference nreport,
        global.H:56: per-step counter print)."""
        if (self.nreport > 0 and self.istep % self.nreport == 0
                and self.is_primary):
            wall = time.time() - self._wall0
            print(f"[exp_tpu_torch] step {self.istep}  time {self.time:.6g}  "
                  f"wall {wall:.1f}s", flush=True)

    def _maybe_recompute_bases(self, multistep=False):
        """Adaptive basis recomputation (Sphere::make_model* — Sphere.H:156,
        Sphere.cc:203-354): for sphereSL components with `dtime > 0`, rebuild
        the SL basis from the binned particle distribution every dtime.  On
        a world every rank gathers the state; rank 0 bins it and builds the
        SL tables, which it broadcasts (build_force's world build)."""
        from exp_tpu_torch.basis.model import model_from_particles
        from exp_tpu_torch.bench_composite import kernel_launches

        for n, c in self.components.items():
            if c.basis_dtime <= 0 or self.time < c.basis_tnext:
                continue
            if multistep:
                self._sync_flat_state()
            if self.dist:
                hp = allgather_ps(self._state[n], self.world)
                model = primary_build(self.world, lambda: model_from_particles(
                    hp.x, hp.mass))
            else:
                ps = self._state[n]
                model = model_from_particles(_host(ps.x), _host(ps.mass))
            fc = c.config.force
            stanza = replace(fc, parameters={
                **{k: v for k, v in fc.parameters.items()
                   if k != "cachename"},
                "_model_object": model})
            self.rebuilds.append({"name": n, "time": self.time,
                                  "launches": kernel_launches()})
            c.force = build_force(stanza, self.compute_dtype, self.workdir,
                                  device=self.device, world=self.world)
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
                parts = c if isinstance(c, tuple) else (c,)
                if not all(np.isfinite(_host(a)).all() for a in parts):
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
        self.stop_requested = True
        if not self.is_primary:
            return
        for n, offlo, nlive in bad:
            print(f"[exp_tpu_torch] multistep overrun: component {n!r} has "
                  f"{offlo}/{nlive} ({100.0 * offlo / nlive:.1f}%) particles "
                  f"below the minimum timestep (> maxMindt="
                  f"{100 * max_mindt:.0f}%)")
        print("[exp_tpu_torch] stopping this run: decrease dtime, increase "
              "multistep, or both, and restart.  Writing a checkpoint.")

    def _run_multistep(self, nsteps=None):
        """Multistep main loop: one big step per dtime, then the boundary
        relevel every `nrelevel` big steps (see nbody/multistep.py)."""
        nsteps = self.nsteps if nsteps is None else nsteps
        r = self._ms_runner
        if self._ms_state is None:
            st, regs, coef, diag = r.init_state(
                self._state, t0=self.time, centers=self._ms_centers(),
                extras_fn=self._make_extras, rots=self._rot_arrays())
            self._ms_state, self._ms_regs = st, regs
            self._capture_frozen(coef)
            self._coefs, self._diag = self._to_host(coef, diag)
            self._sync_flat_state()
            for o in self.outputs:
                o.run(self, self.istep, force=True)
        for _ in range(nsteps):
            if self._check_stop():
                break
            centers = self._ms_centers()
            rots = self._rot_arrays()
            t0 = time.time()
            st, regs, coef, diag = r.bigstep(self._ms_state, self._ms_regs,
                                             self.time, centers=centers,
                                             extras_fn=self._make_extras,
                                             rots=rots)
            t1 = time.time()
            self.timers["Compute"] += t1 - t0
            if (self.istep + 1) % max(1, self.config.glob.nrelevel) == 0:
                st, regs = r.relevel(st, regs, t0=self.time + self.dt,
                                     centers=centers,
                                     extras_fn=self._make_extras, rots=rots)
            t2 = time.time()
            self.timers["Relevel"] += t2 - t1
            self._ms_state, self._ms_regs = st, regs
            self.istep += 1
            self.time += self.dt
            self._nreport_line()
            self._block_end_updates(multistep=True)
            t2 = time.time()
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
        """Wall-clock budget / SIGTERM stop; SIGHUP checkpoint dump.  On a
        world every rank takes the decision of any: the requests and the
        wall-clock test are summed over the ranks first."""
        over = (self.wall_limit is not None
                and time.time() - self._wall0 > self.wall_limit)
        if self.dist:
            f = sum_host(np.array([self.dump_requested, self.stop_requested,
                                   over], np.int64), self.world)
            self.dump_requested, self.stop_requested, over = (
                bool(v) for v in f)
        if self.dump_requested:
            self.dump_requested = False
            self._write_checkpoint()
        if self.stop_requested:
            self._write_checkpoint()
            return True
        if over:
            if self.is_primary:
                print(f"[exp_tpu_torch] wall-clock limit reached at step "
                      f"{self.istep}; checkpointing and stopping")
            self._write_checkpoint()
            if self.restart_cmd and self.is_primary:
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
            if self.dist:
                # collective: every rank gathers, in rank order
                self._host_cache[name] = allgather_ps(ps, self.world)
            else:
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
