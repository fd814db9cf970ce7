"""PSP phase-space toolbox backends (utils/PhaseSpace/; port of
exp_tpu/cli/psptools.py): pspinfo, pspstat, psp2ascii, ascii2psp,
snap2ascii, diffpsp, pspinterp, psp2hdf5, shrinkics, psphisto, pspbox,
snapconvert and snap2vtk.  Each has a thin module wrapper so `python -m
exp_tpu_torch.cli.<tool>` works.  They are host NumPy, with exp_tpu's
flags, printed lines and output files (byte for byte); like every tool
they take --cpu and otherwise refuse without a card.  psp2hdf5 and
snapconvert's gadgethdf5 output need h5py and raise ImportError without
it."""

from __future__ import annotations

import numpy as np

from exp_tpu_torch.cli._common import make_parser


def pspinfo(argv=None):
    """pspinfo — print PSP dump headers."""
    ap = make_parser("pspinfo", pspinfo.__doc__)
    ap.add_argument("file")
    a = ap.parse_args(argv)
    from exp_tpu_torch.io.psp import read_psp

    dumps = read_psp(a.file)
    if not isinstance(dumps, list):
        dumps = [dumps]
    for i, d in enumerate(dumps):
        print(f"Dump {i}: time={d.time:.8g} ntot={d.ntot} "
              f"ncomp={len(d.components)}")
        for c in d.components:
            ni = 0 if c.iattr is None else c.iattr.shape[1]
            nd = 0 if c.dattr is None else c.dattr.shape[1]
            print(f"  {c.name:>12s}: nbod={len(c.mass)} niatr={ni} "
                  f"ndatr={nd}")


def pspstat(argv=None):
    """pspstat — per-component mass/COM/velocity statistics
    (utils/PhaseSpace/pspstat.cc); --all iterates every dump of a
    multi-dump OUT file as a time series (the pspstatT variant)."""
    ap = make_parser("pspstat", pspstat.__doc__)
    ap.add_argument("file")
    ap.add_argument("--dump", type=int, default=-1)
    ap.add_argument("--all", action="store_true",
                    help="statistics for EVERY dump in the file")
    a = ap.parse_args(argv)
    from exp_tpu_torch.io.psp import read_psp

    dumps = read_psp(a.file)
    if not isinstance(dumps, list):
        dumps = [dumps]
    selected = dumps if a.all else [dumps[a.dump]]
    for d in selected:
        _pspstat_one(d)
    return 0


def _pspstat_one(d):
    print(f"time = {d.time:.8g}")
    for c in d.components:
        M = c.mass.sum()
        com = np.average(c.x, axis=0, weights=c.mass)
        vel = np.average(c.v, axis=0, weights=c.mass)
        ke = 0.5 * np.sum(c.mass * (c.v ** 2).sum(1))
        pe = 0.5 * np.sum(c.mass * c.pot)
        print(f"{c.name}: N={len(c.mass)} M={M:.6g} "
              f"COM=({com[0]:.4g},{com[1]:.4g},{com[2]:.4g}) "
              f"V=({vel[0]:.4g},{vel[1]:.4g},{vel[2]:.4g}) "
              f"KE={ke:.6g} PE={pe:.6g}")


def psp2ascii(argv=None):
    """psp2ascii — PSP dump -> ascii body files (one per component)."""
    ap = make_parser("psp2ascii", psp2ascii.__doc__)
    ap.add_argument("file")
    ap.add_argument("-o", "--prefix", default=None)
    ap.add_argument("--dump", type=int, default=-1)
    a = ap.parse_args(argv)
    from exp_tpu_torch.io.psp import read_psp
    from exp_tpu_torch.nbody.particles import write_ascii_bodies

    dumps = read_psp(a.file)
    d = dumps[a.dump] if isinstance(dumps, list) else dumps
    prefix = a.prefix or a.file
    for c in d.components:
        out = f"{prefix}.{c.name}.ascii"
        write_ascii_bodies(out, (c.x, c.v, c.mass))
        print(f"wrote {out} ({len(c.mass)} bodies)")


def ascii2psp(argv=None):
    """ascii2psp — ascii body file -> single-component PSP dump."""
    ap = make_parser("ascii2psp", ascii2psp.__doc__)
    ap.add_argument("file")
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("--name", default="comp")
    ap.add_argument("--time", type=float, default=0.0)
    ap.add_argument("--real4", action="store_true")
    a = ap.parse_args(argv)
    from exp_tpu_torch.io.readers import read_ascii
    from exp_tpu_torch.io.psp import PSPDump, PSPComponent, write_psp

    s = read_ascii(a.file, name=a.name)
    x, v, m = s.GetParticles(a.name)
    d = PSPDump(time=a.time, components=[PSPComponent(
        name=a.name, info=f"name: {a.name}\n", mass=m, x=x, v=v,
        pot=np.zeros(len(m)))])
    out = a.output or a.file + ".psp"
    write_psp(out, d, real4=a.real4)
    print(f"wrote {out}")


def snap2ascii(argv=None):
    """snap2ascii — any supported snapshot -> ascii body file."""
    ap = make_parser("snap2ascii", snap2ascii.__doc__)
    ap.add_argument("file")
    ap.add_argument("--type", default="psp",
                    choices=["psp", "gadget", "tipsy", "ascii"])
    ap.add_argument("--comp", default=None)
    ap.add_argument("-o", "--output", default=None)
    a = ap.parse_args(argv)
    from exp_tpu_torch.io.readers import createReader
    from exp_tpu_torch.nbody.particles import write_ascii_bodies

    s = createReader(a.type, a.file)
    x, v, m = s.GetParticles(a.comp)
    out = a.output or a.file + ".ascii"
    write_ascii_bodies(out, (x, v, m))
    print(f"wrote {out} ({len(m)} bodies)")


def diffpsp(argv=None):
    """diffpsp — phase-space difference statistics between two PSP dumps
    (matched by particle index when available, else by order)."""
    ap = make_parser("diffpsp", diffpsp.__doc__)
    ap.add_argument("file1")
    ap.add_argument("file2")
    a = ap.parse_args(argv)
    from exp_tpu_torch.io.psp import read_psp

    def last(f):
        d = read_psp(f)
        return d[-1] if isinstance(d, list) else d

    d1, d2 = last(a.file1), last(a.file2)
    status = 0
    if len(d1.components) != len(d2.components):
        print(f"component count mismatch: {len(d1.components)} != "
              f"{len(d2.components)}")
        status = 1
    for c1, c2 in zip(d1.components, d2.components):
        x2, v2 = c2.x, c2.v
        if c1.indx is not None and c2.indx is not None:
            # indexed dumps: match particles by indx, not storage order
            o1 = np.argsort(c1.indx)
            o2 = np.argsort(c2.indx)
            c1 = type(c1)(name=c1.name, info=c1.info, mass=c1.mass[o1],
                          x=c1.x[o1], v=c1.v[o1], pot=c1.pot[o1],
                          indx=c1.indx[o1])
            x2, v2 = c2.x[o2], c2.v[o2]
        n = min(len(c1.mass), len(x2))
        dx = np.linalg.norm(c1.x[:n] - x2[:n], axis=1)
        dv = np.linalg.norm(c1.v[:n] - v2[:n], axis=1)
        print(f"{c1.name}: |dx| mean={dx.mean():.6g} max={dx.max():.6g}  "
              f"|dv| mean={dv.mean():.6g} max={dv.max():.6g}")
        if dx.max() > 0 or dv.max() > 0:
            status = 1
    return status


def pspinterp(argv=None):
    """pspinterp — phase-space dump interpolated between two PSP times
    (utils/PhaseSpace/psp2interp.cc): particles matched by order, linear
    in x and v, written as a new PSP at the requested time."""
    ap = make_parser("pspinterp", pspinterp.__doc__)
    ap.add_argument("file1")
    ap.add_argument("file2")
    ap.add_argument("-t", "--time", type=float, required=True)
    ap.add_argument("-o", "--output", default=None)
    a = ap.parse_args(argv)
    from dataclasses import replace
    from exp_tpu_torch.io.psp import read_psp, write_psp

    def last(f):
        d = read_psp(f)
        return d[-1] if isinstance(d, list) else d

    d1, d2 = last(a.file1), last(a.file2)
    if d2.time == d1.time:
        raise SystemExit("dumps have the same time; nothing to interpolate")
    w = (a.time - d1.time) / (d2.time - d1.time)
    if not 0.0 <= w <= 1.0:
        print(f"warning: t={a.time:g} extrapolates outside "
              f"[{d1.time:g}, {d2.time:g}] (w={w:.3f})")
    comps = []
    for c1, c2 in zip(d1.components, d2.components):
        n = min(len(c1.mass), len(c2.mass))
        comps.append(replace(
            c1, mass=c1.mass[:n],
            x=(1 - w) * c1.x[:n] + w * c2.x[:n],
            v=(1 - w) * c1.v[:n] + w * c2.v[:n],
            pot=(1 - w) * c1.pot[:n] + w * c2.pot[:n],
            indx=None if c1.indx is None else c1.indx[:n],
            iattr=None if c1.iattr is None else c1.iattr[:n],
            dattr=None if c1.dattr is None else c1.dattr[:n]))
    out = a.output or f"interp_{a.time:g}.psp"
    write_psp(out, replace(d1, time=a.time, components=comps))
    print(f"wrote {out} (w={w:.4f})")
    return 0


def psp2hdf5(argv=None):
    """psp2hdf5 — PSP dump(s) -> HDF5 snapshot series
    (utils/PhaseSpace/psp2hdf5): same layout as the OutHDF5 writer."""
    ap = make_parser("psp2hdf5", psp2hdf5.__doc__)
    ap.add_argument("file")
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("--real4", action="store_true")
    a = ap.parse_args(argv)
    import h5py
    from exp_tpu_torch.io.psp import read_psp

    dumps = read_psp(a.file)
    if not isinstance(dumps, list):
        dumps = [dumps]
    dt = np.float32 if a.real4 else np.float64
    out = a.output or a.file + ".h5"
    with h5py.File(out, "w") as f:
        f.attrs["count"] = len(dumps)
        for i, d in enumerate(dumps):
            g = f.create_group(f"snapshots/{i:08d}")
            g.attrs["Time"] = float(d.time)
            for c in d.components:
                cg = g.create_group(c.name)
                cg.create_dataset("mass", data=c.mass.astype(dt))
                cg.create_dataset("pos", data=c.x.astype(dt))
                cg.create_dataset("vel", data=c.v.astype(dt))
                cg.create_dataset("pot", data=c.pot.astype(dt))
    print(f"wrote {out} ({len(dumps)} dumps)")


def shrinkics(argv=None):
    """shrinkics — subsample a body file by an integer factor, rescaling
    masses to conserve the total (utils/ICs/shrinkics)."""
    ap = make_parser("shrinkics", shrinkics.__doc__)
    ap.add_argument("file")
    ap.add_argument("-f", "--factor", type=int, default=10)
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("--seed", type=int, default=11)
    a = ap.parse_args(argv)
    from exp_tpu_torch.io.readers import read_ascii
    from exp_tpu_torch.nbody.particles import write_ascii_bodies

    s = read_ascii(a.file, name="c")
    x, v, m = s.GetParticles("c")
    n = len(m)
    keep = np.random.default_rng(a.seed).choice(
        n, size=max(1, n // a.factor), replace=False)
    keep.sort()
    scale = m.sum() / m[keep].sum()
    out = a.output or a.file + ".shrink"
    write_ascii_bodies(out, (x[keep], v[keep], m[keep] * scale))
    print(f"wrote {out} ({len(keep)} of {n} bodies, mass conserved)")


def psphisto(argv=None):
    """psphisto — mass-weighted histogram of a phase-space quantity
    (utils/Analysis/psphisto.cc; pot/E cover utils/PhaseSpace/psp2histoE):
    field in {r, R, x, y, z, vr, vt, v2, pot, E}.  With --field2 the
    output is the 2D (field, field2) mass grid (the psp2histo /
    gas2dcyl R-z histogram shape)."""
    ap = make_parser("psphisto", psphisto.__doc__)
    ap.add_argument("file")
    ap.add_argument("--field", default="r",
                    choices=["r", "R", "x", "y", "z", "vr", "vt", "v2",
                             "pot", "E"])
    ap.add_argument("--field2", default=None,
                    choices=["r", "R", "x", "y", "z", "vr", "vt", "v2",
                             "pot", "E"],
                    help="second axis: write a 2D mass histogram")
    ap.add_argument("--comp", default=None)
    ap.add_argument("--nbins", type=int, default=40)
    ap.add_argument("--nbins2", type=int, default=None)
    ap.add_argument("--log", action="store_true")
    ap.add_argument("-o", "--output", default=None)
    a = ap.parse_args(argv)
    from exp_tpu_torch.io.psp import read_psp

    d = read_psp(a.file)
    if isinstance(d, list):
        d = d[-1]
    cs = [c for c in d.components if a.comp in (None, c.name)]
    x = np.concatenate([c.x for c in cs])
    v = np.concatenate([c.v for c in cs])
    m = np.concatenate([c.mass for c in cs])
    r = np.linalg.norm(x, axis=1)
    rh = np.maximum(r, 1e-12)
    vals = {"r": r, "R": np.hypot(x[:, 0], x[:, 1]), "x": x[:, 0],
            "y": x[:, 1], "z": x[:, 2],
            "vr": np.sum(x * v, axis=1) / rh,
            "v2": np.sum(v * v, axis=1)}
    vals["vt"] = np.sqrt(np.maximum(vals["v2"] - vals["vr"] ** 2, 0.0))
    if a.field in ("pot", "E"):
        pot = np.concatenate([c.pot for c in cs])
        vals["pot"] = pot
        vals["E"] = 0.5 * vals["v2"] + pot
    if a.field2 is not None and a.field2 in ("pot", "E") \
            and "pot" not in vals:
        pot = np.concatenate([c.pot for c in cs])
        vals["pot"] = pot
        vals["E"] = 0.5 * vals["v2"] + pot
    def _edges(q, nb, fieldname):
        if not a.log:
            return np.linspace(q.min(), q.max(), nb + 1)
        if not (q > 0).any():
            raise SystemExit(
                f"--log needs positive values; field {fieldname!r} has "
                "none (use linear bins)")
        lo = max(q[q > 0].min(), 1e-12)
        return np.geomspace(lo, q.max(), nb + 1)

    if a.field2 is not None:
        q1, q2 = vals[a.field], vals[a.field2]
        nb2 = a.nbins2 or a.nbins
        e1 = _edges(q1, a.nbins, a.field)
        e2 = _edges(q2, nb2, a.field2)
        H, _, _ = np.histogram2d(q1, q2, bins=[e1, e2], weights=m)
        out = a.output or f"{a.file}.histo.{a.field}.{a.field2}"
        with open(out, "w") as f:
            f.write(f"# 2D mass histogram: rows={a.field} "
                    f"cols={a.field2}\n")
            f.write("# " + " ".join(f"{0.5 * (e2[j] + e2[j + 1]):.6g}"
                                    for j in range(nb2)) + "\n")
            for i in range(a.nbins):
                f.write(f"{0.5 * (e1[i] + e1[i + 1]):.8g} "
                        + " ".join(f"{H[i, j]:.8g}" for j in range(nb2))
                        + "\n")
        print(f"wrote {out}")
        return
    q = vals[a.field]
    edges = _edges(q, a.nbins, a.field)
    H, _ = np.histogram(q, bins=edges, weights=m)
    out = a.output or f"{a.file}.histo.{a.field}"
    with open(out, "w") as f:
        f.write(f"# {a.field}_center  mass\n")
        for i in range(a.nbins):
            f.write(f"{0.5 * (edges[i] + edges[i + 1]):.8g} {H[i]:.8g}\n")
    print(f"wrote {out}")


def pspbox(argv=None):
    """pspbox — cut a spatial box/sphere out of a PSP dump into a new PSP
    file (utils/Analysis/pspbox.cc)."""
    ap = make_parser("pspbox", pspbox.__doc__)
    ap.add_argument("file")
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("--center", default="0,0,0")
    ap.add_argument("--radius", type=float, default=None,
                    help="spherical cut radius")
    ap.add_argument("--halfside", type=float, default=None,
                    help="cubic box half side")
    a = ap.parse_args(argv)
    from exp_tpu_torch.io.psp import read_psp, write_psp, PSPDump, PSPComponent

    if a.radius is None and a.halfside is None:
        ap.error("need --radius or --halfside")
    ctr = np.array([float(s) for s in a.center.split(",")])
    d = read_psp(a.file)
    if isinstance(d, list):
        d = d[-1]
    out_dump = PSPDump(time=d.time)
    ntot = 0
    for c in d.components:
        rel = c.x - ctr
        if a.radius is not None:
            keep = np.linalg.norm(rel, axis=1) <= a.radius
        else:
            keep = np.all(np.abs(rel) <= a.halfside, axis=1)
        ntot += int(keep.sum())
        out_dump.components.append(PSPComponent(
            name=c.name, info=c.info, mass=c.mass[keep], x=c.x[keep],
            v=c.v[keep], pot=c.pot[keep]))
    out = a.output or a.file + ".box"
    write_psp(out, out_dump)
    print(f"wrote {out} ({ntot} bodies kept)")


def snapconvert(argv=None):
    """snapconvert — universal snapshot format converter (the generic
    replacement for the reference's per-pair converters: ascii2psp2,
    spl2psp, tipstd2psp, psp2hdf5, ...).  Reads any supported format and
    writes psp / ascii / gadget / gadget_hdf5 / tipsy-standard."""
    ap = make_parser("snapconvert", snapconvert.__doc__)
    ap.add_argument("file")
    ap.add_argument("--from", dest="src", default="psp",
                    choices=["psp", "gadget", "gadgetnative", "gadgethdf5",
                             "tipsy", "bonsai", "ascii"])
    ap.add_argument("--to", dest="dst", default="psp",
                    choices=["psp", "ascii", "gadget", "gadgethdf5",
                             "tipsy"])
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("--comp", default=None, help="component (default: all)")
    ap.add_argument("--time", type=float, default=None)
    a = ap.parse_args(argv)
    from exp_tpu_torch.io.readers import (createReader, write_gadget_hdf5,
                                    write_gadget_native)

    s = createReader(a.src, a.file)
    names = [a.comp] if a.comp else s.GetTypes()
    time = a.time if a.time is not None else getattr(s, "time", 0.0)
    out = a.output or f"{a.file}.{a.dst}"
    if a.dst == "ascii":
        from exp_tpu_torch.nbody.particles import write_ascii_bodies

        for n in names:
            x, v, m = s.GetParticles(n)
            path = out if len(names) == 1 else f"{out}.{n}"
            write_ascii_bodies(path, (x, v, m))
            print(f"wrote {path} ({len(m)} bodies)")
    elif a.dst == "psp":
        from exp_tpu_torch.io.psp import PSPDump, PSPComponent, write_psp

        comps = []
        for n in names:
            x, v, m = s.GetParticles(n)
            comps.append(PSPComponent(name=n, info=f"name: {n}\n",
                                      mass=m, x=x, v=v,
                                      pot=np.zeros(len(m))))
        write_psp(out, PSPDump(time=time, components=comps))
        print(f"wrote {out} ({sum(len(c.mass) for c in comps)} bodies)")
    else:
        from exp_tpu_torch.io.readers import Snapshot

        snap = Snapshot(time)
        for n in names:
            x, v, m = s.GetParticles(n)
            snap.add(n, x, v, m, pot=s[n].get("pot"))
        if a.dst == "gadgethdf5":
            write_gadget_hdf5(out, snap)
        elif a.dst == "tipsy":
            from exp_tpu_torch.io.readers import write_tipsy

            write_tipsy(out, snap)
        else:
            write_gadget_native(out, snap)
        print(f"wrote {out}")


def snap2vtk(argv=None):
    """snap2vtk — particles -> legacy-VTK point cloud with mass (and
    optional potential) scalars, for ParaView (the reference's psp2vtu).
    With --grid N the output is instead an N^3 STRUCTURED_POINTS density
    grid binned from the particles (utils/Analysis/makegrid.cc)."""
    ap = make_parser("snap2vtk", snap2vtk.__doc__)
    ap.add_argument("file")
    ap.add_argument("--type", default="psp",
                    choices=["psp", "gadget", "tipsy", "ascii"])
    ap.add_argument("--comp", default=None)
    ap.add_argument("--stride", type=int, default=1)
    ap.add_argument("--grid", type=int, default=0, metavar="N",
                    help="write an N^3 binned-density structured grid "
                         "instead of a point cloud (makegrid.cc)")
    ap.add_argument("--rmax", type=float, default=None,
                    help="half-extent of the --grid box (default: the "
                         "95th-percentile radius)")
    ap.add_argument("-o", "--output", default=None)
    a = ap.parse_args(argv)
    from exp_tpu_torch.io.readers import createReader

    s = createReader(a.type, a.file)
    x, v, m = s.GetParticles(a.comp)
    if a.grid:
        x = np.asarray(x)
        m = np.asarray(m)
        N = a.grid
        rmax = a.rmax or float(np.percentile(
            np.abs(x).max(axis=1), 95.0))
        edges = np.linspace(-rmax, rmax, N + 1)
        H, _ = np.histogramdd(x, bins=(edges, edges, edges), weights=m)
        dx = 2.0 * rmax / N
        H /= dx ** 3                                   # mass -> density
        out = a.output or a.file + ".grid.vtk"
        with open(out, "w") as f:
            f.write("# vtk DataFile Version 3.0\nexp_tpu density grid\n"
                    "ASCII\nDATASET STRUCTURED_POINTS\n")
            f.write(f"DIMENSIONS {N} {N} {N}\n")
            f.write(f"ORIGIN {-rmax + 0.5 * dx:.7g} "
                    f"{-rmax + 0.5 * dx:.7g} {-rmax + 0.5 * dx:.7g}\n")
            f.write(f"SPACING {dx:.7g} {dx:.7g} {dx:.7g}\n")
            f.write(f"POINT_DATA {N ** 3}\nSCALARS density float 1\n"
                    "LOOKUP_TABLE default\n")
            # VTK structured points iterate x fastest
            np.savetxt(f, H.transpose(2, 1, 0).reshape(-1), fmt="%.7g")
        print(f"wrote {out} ({N}^3 grid, rmax={rmax:.4g})")
        return
    x = np.asarray(x)[::a.stride]
    v = np.asarray(v)[::a.stride]
    m = np.asarray(m)[::a.stride]
    n = len(m)
    out = a.output or a.file + ".vtk"
    with open(out, "w") as f:
        f.write("# vtk DataFile Version 3.0\nexp_tpu particles\nASCII\n")
        f.write("DATASET POLYDATA\n")
        f.write(f"POINTS {n} float\n")
        np.savetxt(f, x, fmt="%.7g")
        f.write(f"VERTICES {n} {2 * n}\n")
        np.savetxt(f, np.stack([np.ones(n, int),
                                np.arange(n)], -1), fmt="%d")
        f.write(f"POINT_DATA {n}\nSCALARS mass float 1\n"
                "LOOKUP_TABLE default\n")
        np.savetxt(f, m, fmt="%.7g")
        f.write("VECTORS velocity float\n")
        np.savetxt(f, v, fmt="%.7g")
    print(f"wrote {out} ({n} points)")
