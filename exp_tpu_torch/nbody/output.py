"""Periodic output writers (port of exp_tpu/nbody/output.py; the reference's
Output framework).

Host-side writers dispatched from the run loop every `nint` steps, mirroring
the reference's OutputContainer factory + writers (src/OutputContainer.cc:48-
123; OutLog.cc; OutCoef; OutCHKPT.H):

  OutLog   — conserved-quantity table (global + per component): the OUTLOG
             columns incl. the 2T/VC virial diagnostic (OutLog.cc:24-52,592).
  OutCoef  — pyEXP-compatible HDF5 coefficient file per component.
  OutChkpt — full-precision HDF5 phase-space checkpoint with .bak rotation
             (OutCHKPT.H:6-20); restart via restore_checkpoint.
  OutPSN / OutSPL / OutPS — PSP snapshots (one file a dump, split SPL
             master + blobs, or all dumps in one OUT file); OutHDF5 — an
             HDF5 snapshot series.
  OutMulti, OrbTrace, OutDiag, OutFrac, OutCalbr, OutAscii — level
             populations, orbit traces, radial shells, Lagrangian radii,
             the energy/angular-momentum calibration and ascii dumps.

The files are exp_tpu's, byte for byte where the values are equal.  On a
world of several ranks a due writer first runs `gather` on every rank (the
collectives it needs: the phase-space gather of `sim.host_ps`, the level
counts, the subsample projections), then `write` on rank 0 alone, which
also alone creates the files (exp_tpu's gather/write split and its
process-0 gating).  OutVel writes the velocity-field coefficients through
analysis/field_basis.py, each rank's rows projected and summed over the
ranks as OutSamp's subsample covariance (nbody/pca.py) is.

Writers read the host copies the driver makes (`sim.host_ps`, and the
coefficients and diagnostics it brings to the host once at an output
step); `_host` turns any tensor into a NumPy array.
"""

from __future__ import annotations

import os
import time

import numpy as np

from exp_tpu_torch.nbody.particles import ParticleSystem, _host


class Output:
    """Writer base: `run` writes when forced or when `nint` divides the
    step."""

    def __init__(self, sim, nint=1, **kw):
        self.sim = sim
        self.nint = int(nint)

    def run(self, sim, istep, force=False):
        if force or (self.nint > 0 and istep % self.nint == 0):
            self.gather(sim)
            if _primary(sim):
                self.write(sim, istep)

    def gather(self, sim):
        """The collectives every rank takes part in before rank 0 writes;
        nothing by default."""

    def write(self, sim, istep):
        raise NotImplementedError


def _primary(sim):
    """True on the rank that writes (every run on one device)."""
    return getattr(sim, "is_primary", True)


def _gather_all(sim):
    """Every component's host phase space (a collective on a world)."""
    for n in sim.components:
        sim.host_ps(n)


class _OneComponent(Output):
    """A writer of one component's host phase space: its gather makes the
    host copy `write` reads (`sim.host_ps`, a collective on a world)."""

    def gather(self, sim):
        sim.host_ps(self.name)


def _fresh(sim, path):
    """True when a writer should (re)create `path`: not a restart, or no
    prior file exists.  On `infile:` restarts existing outputs are
    CONTINUED (the reference appends on restart) instead of truncated —
    and truncation must not happen before restore_checkpoint runs."""
    return not (getattr(sim, "is_restart", False) and os.path.exists(path))


class OutLog(Output):
    """OUTLOG.<runtag>: pipe-separated conserved-quantity table."""

    GLOBAL_COLS = ["Time", "mass", "bodies", "R(x)", "R(y)", "R(z)",
                   "V(x)", "V(y)", "V(z)", "L(x)", "L(y)", "L(z)",
                   "KE", "PE", "VC", "E", "2T/VC", "Clock"]

    def __init__(self, sim, nint=1, filename=None, **kw):
        super().__init__(sim, nint)
        self.path = os.path.join(
            sim.outdir, filename or f"OUTLOG.{sim.runtag}")
        self._wall0 = time.time()
        names = list(sim.components)
        comp_cols = ["mass", "R(x)", "R(y)", "R(z)", "V(x)", "V(y)",
                     "V(z)", "L(x)", "L(y)", "L(z)", "KE", "PE", "VC",
                     "E", "2T/VC"]
        cols = list(self.GLOBAL_COLS)
        for n in names:
            cols += [f"{n}:{c}" for c in comp_cols]
        if not _primary(sim) or not _fresh(sim, self.path):
            return                      # restart: append to the old log
        with open(self.path, "w") as f:
            f.write(f"# exp_tpu run {sim.runtag}; components: "
                    f"{', '.join(names)}\n")
            f.write("# Columns: global totals then per-component sections; "
                    "energies G=1\n")
            f.write("|".join(f"{c:>16s}" for c in cols) + "\n")

    def gather(self, sim):
        if not hasattr(self, "_nlive"):
            # live particles only — ps.n includes zero-mass padding rows
            from exp_tpu_torch.parallel.distributed import sum_host

            n = sum(int((c.ps.mass > 0).sum())
                    for c in sim.components.values())
            self._nlive = int(sum_host(np.array([n], np.int64),
                                       getattr(sim, "world", None))[0])

    def write(self, sim, istep):
        d = sim.total_diag()
        mass = float(d["mass"])
        com = np.asarray(d["com"]) / mass
        mom = np.asarray(d["mom"]) / mass
        L = np.asarray(d["L"])
        ke, pe, vc = float(d["KE"]), float(d["PE"]), float(d["VC"])
        ratio = -2.0 * ke / vc if vc != 0 else np.nan
        nb = self._nlive
        row = [sim.time, mass, nb, *com, *mom, *L, ke, pe, vc, ke + vc,
               ratio, time.time() - self._wall0]
        # per-component sections (the reference's lab_component columns,
        # OutLog.cc:34-52) appended after the global block
        for n, dc in (sim._diag or {}).items():
            mc = float(dc["mass"])
            cc = np.asarray(dc["com"]) / max(mc, 1e-30)
            vv = np.asarray(dc["mom"]) / max(mc, 1e-30)
            Lc = np.asarray(dc["L"])
            kec, pec, vcc = (float(dc["KE"]), float(dc["PE"]),
                             float(dc["VC"]))
            rc = -2.0 * kec / vcc if vcc != 0 else np.nan
            row += [mc, *cc, *vv, *Lc, kec, pec, vcc, kec + vcc, rc]
        with open(self.path, "a") as f:
            f.write("|".join(
                f"{v:>16d}" if isinstance(v, (int, np.integer))
                else f"{v:>16.8g}" for v in row) + "\n")


class OutCoef(Output):
    """Coefficient snapshots to a pyEXP-compatible HDF5 file."""

    def __init__(self, sim, nint=1, name=None, filename=None, **kw):
        super().__init__(sim, nint)
        if name is None:
            name = next(iter(sim.components))
        self.name = name
        comp = sim.components[name]
        self.file = None
        if not _primary(sim):
            return
        from exp_tpu_torch.forces.cube import Cube
        from exp_tpu_torch.forces.cylinder import CylinderForce
        from exp_tpu_torch.io.coefs import (CubeCoefsFile, CylCoefsFile,
                                            SphCoefsFile)

        path = os.path.join(sim.outdir,
                            filename or f"outcoef.{name}.{sim.runtag}.h5")
        mode = "w"
        if not _fresh(sim, path):
            mode = "a"                  # restart: extend the series
        elif os.path.exists(path):
            os.remove(path)
        force = comp.force
        if isinstance(force, Cube):
            self.file = CubeCoefsFile(
                path, mode, name=name, nmaxx=force.nmaxx, nmaxy=force.nmaxy,
                nmaxz=force.nmaxz)
        elif isinstance(force, CylinderForce):
            self.file = CylCoefsFile(
                path, mode, name=name, mmax=force.mmax, nmax=force.nmax)
        else:
            self.file = SphCoefsFile(
                path, mode, name=name, lmax=force.lmax, nmax=force.nmax,
                scale=getattr(force, "scale", 1.0),
                forceID=comp.config.force.id)

    def write(self, sim, istep):
        coef = _host(sim._coefs[self.name])
        self.file.append(sim.time, coef)
        self.file._f.flush()


class OutChkpt(Output):
    """Rotating full-precision checkpoint (HDF5) with .bak generations
    (OutCHKPT/OutCHKPTQ, OutCHKPT.H:6-20: nbak=1 gives the reference's
    single-.bak behavior; nbak>1 keeps .bak, .bak1, ... .bak<nbak-1>)."""

    def __init__(self, sim, nint=100, filename=None, nbak=1, real4=False,
                 **kw):
        super().__init__(sim, nint)
        self.path = os.path.join(sim.outdir,
                                 filename or f"OUT.{sim.runtag}.chkpt")
        self.nbak = max(1, int(nbak))
        # single-precision storage: the reference's OutCHKPTQ "quick"
        # checkpoints (OutCHKPT.H:6-20)
        self.real4 = bool(real4)

    def gather(self, sim):
        _gather_all(sim)

    def _rotate(self):
        baks = [self.path + ".bak"] + [f"{self.path}.bak{i}"
                                       for i in range(1, self.nbak)]
        for older, newer in zip(reversed(baks), reversed([self.path]
                                                         + baks[:-1])):
            if os.path.exists(newer):
                os.replace(newer, older)

    def write(self, sim, istep):
        import h5py

        self._rotate()
        with h5py.File(self.path, "w") as f:
            f.attrs["time"] = sim.time
            f.attrs["istep"] = sim.istep
            f.attrs["runtag"] = sim.runtag
            for n, c in sim.components.items():
                ps = sim.host_ps(n)
                g = f.create_group(n)
                for k in ("x", "v", "mass", "pot", "level",
                          "indx", "scale"):
                    a = np.asarray(getattr(ps, k))
                    if self.real4 and a.dtype == np.float64:
                        a = a.astype(np.float32)
                    g.create_dataset(k, data=a)


def restore_checkpoint(sim, path=None, as_new=False):
    """Restart from an OutChkpt file (the reference's `infile:` restart,
    Component.H:202-204, Component.cc:3253).

    as_new: restore only the phase space, keep time/istep at zero and
    start fresh outputs (Global restart_as_new / ignore_info,
    parse.cc:243).  h5py is imported only for an HDF5 checkpoint."""
    path = path or os.path.join(sim.outdir, f"OUT.{sim.runtag}.chkpt")
    # PSP binary checkpoints also restart (the reference's native format)
    with open(path, "rb") as fh:
        magic_hdf = fh.read(8)
    if not magic_hdf.startswith(b"\x89HDF"):
        from exp_tpu_torch.io.psp import read_psp

        d = read_psp(path)
        if isinstance(d, list):
            d = d[-1]
        if not as_new:
            sim.time = float(d.time)
            # PSP dumps carry no step counter; reconstruct it from the time
            # so nint scheduling / nrelevel cadence match the HDF5 path
            if sim.dt > 0:
                sim.istep = int(round(sim.time / sim.dt))
        state = {}
        for c in d.components:
            if c.name not in sim.components:
                continue
            state[c.name] = _restored(sim, c.x, c.v, c.mass, indx=c.indx)
            _restored_rows(sim, c.name, c.mass)
        if state:
            sim._state.update(state)
        _reset_derived_state(sim)
        return sim
    import h5py

    with h5py.File(path, "r") as f:
        if not as_new:
            sim.time = float(f.attrs["time"])
            sim.istep = int(f.attrs["istep"])
        state = {}
        for n in sim.components:
            g = f[n]
            state[n] = _restored(
                sim, g["x"][...], g["v"][...], g["mass"][...],
                indx=g["indx"][...] if "indx" in g else None,
                scale=g["scale"][...] if "scale" in g else None)
            _restored_rows(sim, n, g["mass"])
    sim._state = state
    _reset_derived_state(sim)
    return sim


def _restored_rows(sim, name, mass):
    """A world's record of a restored component's global rows before the
    padding (Simulation._nrows, the host operators' row set)."""
    if getattr(sim, "dist", False):
        sim._nrows[name] = len(mass)


def _restored(sim, x, v, mass, indx=None, scale=None):
    """A component's restored state on the run's device; on a world of
    several ranks this rank's row block of it, the global count padded to
    a multiple of the world size with zero-mass rows."""
    if not getattr(sim, "dist", False):
        return ParticleSystem.from_arrays(x, v, mass, dtype=sim.compute_dtype,
                                          indx=indx, scale=scale,
                                          device=sim.device)
    from exp_tpu_torch.parallel.distributed import (pad_global_count,
                                                    ps_from_local, row_block)

    w = sim.world
    n = len(mass)
    npad = pad_global_count(n, w) - n

    def pad(a, fill=0.0):
        if a is None:
            return None
        a = np.asarray(a)
        return np.concatenate([a, np.full((npad,) + a.shape[1:], fill,
                                          a.dtype)])

    lo, hi = row_block(n + npad, w)
    ix = pad(indx, 0)
    sc = pad(scale, -1.0)
    return ps_from_local(pad(x)[lo:hi], pad(v)[lo:hi], pad(mass)[lo:hi], w,
                         n + npad, lo, dtype=sim.compute_dtype,
                         indx=None if ix is None else ix[lo:hi],
                         scale=None if sc is None else sc[lo:hi])


def _reset_derived_state(sim):
    """Drop everything derived from the (replaced) particle state:
    coefficients recompute on prime(), multistep buckets/registers rebuild
    from the restored flat state on the next run (levels are derived, same
    as the reference), the host mirror cache is stale, and writers that
    difference against the previous output (OutCalbr) must not mix
    pre-restore values with the restored state."""
    sim._coefs = None
    sim._ms_state = None
    sim._ms_regs = None
    sim._host_cache = {}
    sim._host_cache_step = {}
    for o in getattr(sim, "outputs", []):
        if isinstance(o, OutCalbr):
            o._prev = None


class OutPSN(Output):
    """PSP binary snapshot per nint steps (OUT.runtag.NNNNN files —
    the reference's OutPSN writer)."""

    def __init__(self, sim, nint=100, real4=True, indexing=False,
                 nbeg=None, **kw):
        super().__init__(sim, nint)
        self.real4 = bool(real4)
        self.indexing = bool(indexing)
        # reference OutPSN/OutPSQ/OutPSR number dumps with a sequence
        # counter starting at `nbeg`, incremented per file written
        # (OutPSQ.H:10-13); default keeps the step-number suffix.
        self._seq = None if nbeg is None else int(nbeg)

    def gather(self, sim):
        _gather_all(sim)

    def _suffix(self, istep):
        if self._seq is None:
            return istep
        s, self._seq = self._seq, self._seq + 1
        return s

    def _dump(self, sim):
        from exp_tpu_torch.io.psp import PSPComponent, PSPDump

        dump = PSPDump(time=sim.time)
        for n in sim.components:
            ps = sim.host_ps(n)
            live = np.asarray(ps.mass) > 0
            dump.components.append(PSPComponent(
                name=n, info=f"name: {n}\n",
                mass=np.asarray(ps.mass)[live],
                x=np.asarray(ps.x)[live], v=np.asarray(ps.v)[live],
                pot=np.asarray(ps.pot)[live],
                indx=np.asarray(ps.indx)[live].astype(np.uint64)))
        return dump

    def write(self, sim, istep):
        from exp_tpu_torch.io.psp import write_psp

        path = os.path.join(sim.outdir,
                            f"OUT.{sim.runtag}.{self._suffix(istep):05d}")
        write_psp(path, self._dump(sim), real4=self.real4,
                  indexing=self.indexing)


class OutSPL(OutPSN):
    """Split-PSP snapshot per nint steps: SPL.runtag.NNNNN master +
    per-part blobs (the reference's OutPSP per-node writer, OutPSP.cc —
    here the split count is a parameter rather than the MPI rank count;
    reassemble with `spl2psp` or read directly via io.psp.read_spl)."""

    def __init__(self, sim, nint=100, real4=True, indexing=False,
                 nparts=0, nbeg=None, **kw):
        super().__init__(sim, nint, real4=real4, indexing=indexing,
                         nbeg=nbeg)
        # exp_tpu's default is its device count: one device here
        self.nparts = int(nparts) or 1

    def write(self, sim, istep):
        from exp_tpu_torch.io.psp import write_spl

        path = os.path.join(sim.outdir,
                            f"SPL.{sim.runtag}.{self._suffix(istep):05d}")
        write_spl(path, self._dump(sim), nparts=self.nparts,
                  real4=self.real4, indexing=self.indexing)


class OutPS(OutPSN):
    """All PSP dumps appended to a single OUT.<runtag> file (the
    reference's OutPS writer; read back with read_psp which returns the
    dump list)."""

    def __init__(self, sim, nint=100, real4=True, indexing=False, **kw):
        super().__init__(sim, nint, real4=real4, indexing=indexing)
        self.path = os.path.join(sim.outdir, f"OUT.{sim.runtag}")
        # restart: keep appending to the existing multi-dump OUT file
        self._started = not _fresh(sim, self.path)

    def write(self, sim, istep):
        from exp_tpu_torch.io.psp import write_psp

        write_psp(self.path, self._dump(sim), real4=self.real4,
                  indexing=self.indexing, append=self._started)
        self._started = True


class OutHDF5(Output):
    """HDF5 phase-space snapshot series (the reference's OutHDF5 writer):
    one file, one group per dump with per-component mass/pos/vel/pot."""

    def __init__(self, sim, nint=100, filename=None, real4=True, **kw):
        super().__init__(sim, nint)
        self.path = os.path.join(sim.outdir,
                                 filename or f"OUT.{sim.runtag}.h5")
        self.dtype = np.float32 if real4 else np.float64
        import h5py

        self._count = 0
        if not _primary(sim):
            return
        if _fresh(sim, self.path):
            with h5py.File(self.path, "w") as f:
                f.attrs["runtag"] = sim.runtag
        else:                       # restart: continue the snapshot series
            with h5py.File(self.path, "r") as f:
                self._count = int(f.attrs.get("count", 0))

    def gather(self, sim):
        _gather_all(sim)

    def write(self, sim, istep):
        import h5py

        with h5py.File(self.path, "a") as f:
            g = f.create_group(f"snapshots/{self._count:08d}")
            g.attrs["Time"] = float(sim.time)
            g.attrs["step"] = int(istep)
            for n in sim.components:
                ps = sim.host_ps(n)
                live = np.asarray(ps.mass) > 0
                c = g.create_group(n)
                c.create_dataset("mass",
                                 data=np.asarray(ps.mass)[live]
                                 .astype(self.dtype))
                c.create_dataset("pos", data=np.asarray(ps.x)[live]
                                 .astype(self.dtype))
                c.create_dataset("vel", data=np.asarray(ps.v)[live]
                                 .astype(self.dtype))
                c.create_dataset("pot", data=np.asarray(ps.pot)[live]
                                 .astype(self.dtype))
            f.attrs["count"] = self._count + 1
        self._count += 1


class OutMulti(Output):
    """Multistep level populations (the reference's OutMulti +
    print_level_lists `runtag.levels`, src/step.cc:228)."""

    def __init__(self, sim, nint=1, **kw):
        super().__init__(sim, nint)
        self.path = os.path.join(sim.outdir, f"{sim.runtag}.levels")
        if not _primary(sim) or not _fresh(sim, self.path):
            return
        with open(self.path, "w") as f:
            f.write("# time  component  counts per level 0..M\n")

    def gather(self, sim):
        self._counts = None
        if sim._ms_runner is not None and sim._ms_state is not None:
            self._counts = sim._ms_runner.level_counts(sim._ms_state)

    def write(self, sim, istep):
        counts = self._counts
        if counts is None:
            return
        with open(self.path, "a") as f:
            for n, cs in counts.items():
                f.write(f"{sim.time:.8g} {n} " +
                        " ".join(str(c) for c in cs) + "\n")


class OutVel(Output):
    """Velocity-field coefficient snapshots (the reference's OutVel over
    expui FieldBasis): the component's 'dens', vx, vy and vz coefficients
    (analysis.field_basis, f32 sums as exp_tpu's) appended to an HDF5 file
    as one group a dump.  On a world each rank projects its own rows and
    the sums are added over the ranks (parallel.all_reduce, as
    world_coefficients does); no phase space is gathered."""

    def __init__(self, sim, nint=10, name=None, **kw):
        super().__init__(sim, nint)
        self.name = name or next(iter(sim.components))
        from exp_tpu_torch.analysis.field_basis import FieldBasis

        self.fb = FieldBasis(sim.components[self.name].force)
        self.path = os.path.join(sim.outdir,
                                 f"outvel.{self.name}.{sim.runtag}.h5")
        if (_primary(sim) and _fresh(sim, self.path)
                and os.path.exists(self.path)):
            os.remove(self.path)

    def gather(self, sim):
        import torch

        from exp_tpu_torch.analysis.basis import download
        from exp_tpu_torch.parallel.distributed import all_reduce

        ps = sim._state[self.name]
        c = self.fb.coefficients(ps.x, ps.v, ps.mass,
                                 accum_dtype=torch.float32)
        world = getattr(sim, "world", None)
        self._coefs = download({k: all_reduce(v, world)
                                for k, v in c.items()})

    def write(self, sim, istep):
        import h5py

        mode = "a" if os.path.exists(self.path) else "w"
        with h5py.File(self.path, mode) as f:
            if "fields" not in f.attrs:
                f.attrs["fields"] = list(self._coefs.keys())
                f.attrs["name"] = self.name
            g = f.create_group(f"snap{len(f.keys()):08d}")
            g.attrs["Time"] = sim.time
            for k, c in self._coefs.items():
                g.create_dataset(k, data=np.asarray(c))


class OutSamp(Output):
    """Subsample coefficient covariance (the reference's OutSamp over
    Covariance.cc): the component's `nsamples` round-robin subsample
    projections, their mean and variance appended to an HDF5 file."""

    def __init__(self, sim, nint=20, name=None, nsamples=8, **kw):
        super().__init__(sim, nint)
        self.name = name or next(iter(sim.components))
        self.nsamples = int(nsamples)
        self.path = os.path.join(sim.outdir,
                                 f"outsamp.{self.name}.{sim.runtag}.h5")
        if (_primary(sim) and _fresh(sim, self.path)
                and os.path.exists(self.path)):
            os.remove(self.path)

    def gather(self, sim):
        from exp_tpu_torch.nbody.pca import subsample_coefficients

        ps = sim._state[self.name]
        self._cs = subsample_coefficients(
            sim.components[self.name].force, ps.x, ps.mass,
            nsamples=self.nsamples, world=getattr(sim, "world", None))

    def write(self, sim, istep):
        from exp_tpu_torch.nbody.pca import write_covariance_h5

        write_covariance_h5(self.path, sim.time, self._cs, name=self.name)


class OrbTrace(_OneComponent):
    """Trace selected particle orbits to a text file (the reference's
    OrbTrace writer)."""

    def __init__(self, sim, nint=1, name=None, norb=5, orbitlist=None, **kw):
        super().__init__(sim, nint)
        self.name = name or next(iter(sim.components))
        # 1-based persistent particle ids (ParticleSystem.indx) — stable
        # under multistep rebucketing, unlike array positions
        self.idx = (list(orbitlist) if orbitlist
                    else list(range(1, int(norb) + 1)))
        self.path = os.path.join(sim.outdir, f"ORBTRACE.{sim.runtag}")
        if not _primary(sim) or not _fresh(sim, self.path):
            return
        with open(self.path, "w") as f:
            f.write("# time then (x y z u v w) per traced orbit: "
                    f"{self.idx}" + chr(10))

    def write(self, sim, istep):
        ps = sim.host_ps(self.name)
        indx = np.asarray(ps.indx)
        order = np.argsort(indx)
        rows = order[np.searchsorted(indx[order], self.idx)]
        x = np.asarray(ps.x)[rows]
        v = np.asarray(ps.v)[rows]
        with open(self.path, "a") as f:
            f.write(f"{sim.time:.10g} " + " ".join(
                f"{a:.8g}" for row in np.concatenate([x, v], 1)
                for a in row) + chr(10))


class OutDiag(_OneComponent):
    """Per-radial-shell diagnostic table (the reference's OutDiag)."""

    def __init__(self, sim, nint=10, name=None, nbins=20, rmax=None, **kw):
        super().__init__(sim, nint)
        self.name = name or next(iter(sim.components))
        self.nbins = int(nbins)
        self.rmax = rmax
        self.path = os.path.join(sim.outdir, f"OUTDIAG.{sim.runtag}")
        if not _primary(sim) or not _fresh(sim, self.path):
            return
        with open(self.path, "w") as f:
            f.write("# time r_mid N mass KE PE_avg" + chr(10))

    def write(self, sim, istep):
        ps = sim.host_ps(self.name)
        m = np.asarray(ps.mass)
        live = m > 0
        x = np.asarray(ps.x)[live]
        v = np.asarray(ps.v)[live]
        pot = np.asarray(ps.pot)[live]
        m = m[live]
        r = np.linalg.norm(x, axis=1)
        rmax = self.rmax or np.quantile(r, 0.99)
        edges = np.geomspace(max(r.min(), rmax * 1e-4), rmax,
                             self.nbins + 1)
        idx = np.clip(np.digitize(r, edges) - 1, 0, self.nbins - 1)
        with open(self.path, "a") as f:
            for b in range(self.nbins):
                sel = idx == b
                if not sel.any():
                    continue
                rc = np.sqrt(edges[b] * edges[b + 1])
                ke = 0.5 * np.sum(m[sel] * (v[sel] ** 2).sum(1))
                f.write(f"{sim.time:.8g} {rc:.8g} {int(sel.sum())} "
                        f"{m[sel].sum():.8g} {ke:.8g} "
                        f"{np.average(pot[sel], weights=m[sel]):.8g}"
                        + chr(10))


class OutFrac(_OneComponent):
    """Mass-fraction (Lagrangian) radii vs time (the reference's OutFrac)."""

    FRACS = [0.01, 0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99]

    def __init__(self, sim, nint=10, name=None, **kw):
        super().__init__(sim, nint)
        self.name = name or next(iter(sim.components))
        self.path = os.path.join(sim.outdir, f"OUTFRAC.{sim.runtag}")
        if not _primary(sim) or not _fresh(sim, self.path):
            return
        with open(self.path, "w") as f:
            f.write("# time then r at mass fractions "
                    f"{self.FRACS}" + chr(10))

    def write(self, sim, istep):
        ps = sim.host_ps(self.name)
        m = np.asarray(ps.mass)
        live = m > 0
        r = np.linalg.norm(np.asarray(ps.x)[live], axis=1)
        m = m[live]
        order = np.argsort(r)
        cum = np.cumsum(m[order]) / m.sum()
        radii = [r[order][np.searchsorted(cum, fr)] for fr in self.FRACS]
        with open(self.path, "a") as f:
            f.write(f"{sim.time:.10g} " + " ".join(
                f"{v:.8g}" for v in radii) + chr(10))


class OutCalbr(_OneComponent):
    """Integration-accuracy calibration (the reference's OutCalbr,
    src/OutCalbr.H:7-35): rms change in per-particle energy and angular
    momentum between output intervals, binned by energy.  Columns per bin:
    E_center, rms dE, rms dLx, rms dLy, rms dLz, count."""

    def __init__(self, sim, nint=10, name=None, num=10, **kw):
        super().__init__(sim, nint)
        self.name = name or next(iter(sim.components))
        self.num = int(num)
        self.path = os.path.join(sim.outdir, f"OUTCALBR.{sim.runtag}")
        self._prev = None   # (E, L) at last output
        self.Emin = None    # bins fixed lazily at the first write (state
                            # and potentials exist only after prime)

    def _energies(self, sim):
        ps = sim.host_ps(self.name)
        m = np.asarray(ps.mass)
        live = m > 0
        # order by the persistent particle id so consecutive outputs
        # difference the SAME particles even after multistep rebucketing
        order = np.argsort(np.asarray(ps.indx)[live])
        x = np.asarray(ps.x)[live][order]
        v = np.asarray(ps.v)[live][order]
        E = 0.5 * np.sum(v * v, axis=1) + np.asarray(ps.pot)[live][order]
        L = np.cross(x, v)
        return E, L

    def write(self, sim, istep):
        E, L = self._energies(sim)
        if self.Emin is None:
            self.Emin, self.Emax = float(E.min()), float(E.max())
            self.dE = (self.Emax - self.Emin) / self.num or 1.0
            Ec = self.Emin + self.dE * (np.arange(self.num) + 0.5)
            with open(self.path, "w") as f:
                f.write("# per-bin rms dE, dLx, dLy, dLz, N since last "
                        "output" + chr(10))
                f.write("# E bin centers: "
                        + " ".join(f"{v:.6g}" for v in Ec) + chr(10))
        if self._prev is not None:
            E0, L0 = self._prev
            idx = np.clip(((E - self.Emin) / self.dE).astype(int),
                          0, self.num - 1)
            cols = np.concatenate([(E - E0)[:, None] ** 2, (L - L0) ** 2],
                                  axis=1)
            sums = np.zeros((self.num, 4))
            np.add.at(sums, idx, cols)
            cnt = np.bincount(idx, minlength=self.num).astype(float)
            rms = np.sqrt(sums / np.maximum(cnt, 1.0)[:, None])
            with open(self.path, "a") as f:
                f.write(f"{sim.time:.10g} " + " ".join(
                    f"{rms[b, 0]:.6g} {rms[b, 1]:.6g} {rms[b, 2]:.6g} "
                    f"{rms[b, 3]:.6g} {int(cnt[b])}"
                    for b in range(self.num)) + chr(10))
        self._prev = (E, L)


class OutAscii(_OneComponent):
    def __init__(self, sim, nint=100, name=None, **kw):
        super().__init__(sim, nint)
        self.name = name or next(iter(sim.components))

    def write(self, sim, istep):
        from exp_tpu_torch.nbody.particles import write_ascii_bodies

        path = os.path.join(sim.outdir,
                            f"{self.name}.{sim.runtag}.{istep:05d}.ascii")
        write_ascii_bodies(path, sim.host_ps(self.name))
