"""YAML run configuration (a jax-free copy of exp_tpu/config.py: the
reference's config schema, validated).

Parses the same stanza layout as the reference (src/parse.cc:64-501:
Global / Components / Output / External / Interaction) into validated
dataclasses with unknown-key detection (the YamlCheck/`unmatched()` behavior
that hard-fails bad configs, OutputContainer.cc:128-131).  The keys, their
meanings and their defaults are exp_tpu's.

Difference from the JAX module: `yaml` is imported only where a file is
read or written, so `RunConfig.from_dict` runs on a machine without PyYAML.
`fpe: trace` has no PyTorch counterpart of jax_debug_nans; the driver runs
the `fpe: true` guard for it (nbody/simulation.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field


class ConfigError(ValueError):
    pass


def _check_keys(mapping: dict, allowed: set, where: str):
    unknown = set(mapping) - allowed
    if unknown:
        raise ConfigError(f"unknown key(s) {sorted(unknown)} in {where}; "
                          f"allowed: {sorted(allowed)}")


_GLOBAL_KEYS = {
    "dtime", "nsteps", "runtag", "multistep", "nbodmax", "VERBOSE",
    "dynfracV", "dynfracA", "dynfracP", "dynfracS", "dynfracD",
    "infile", "ldlibdir", "outdir", "nthrds", "cuda", "allcouples",
    "restart", "nbalance", "dbthresh", "dtime_rel", "shiftlevl",
    "compute_dtype", "accum_dtype", "fpe", "maxMindt", "nrelevel",
    "fused_bigstep", "cap_headroom",
    # reference Global keys honored by the runner (src/parse.cc:64-376)
    "runtime", "restart_cmd", "nreport", "random_seed", "eqmotion",
    "restart_as_new", "NICE", "rlimit", "use_cwd", "homedir",
    "centerlevl",
}

#: reference Global keys accepted but meaningless here (MPI/CUDA/pthread
#: plumbing, debugger hooks): parse without error so genuine reference
#: configs run unmodified, warn at VERBOSE>0 (src/parse.cc:64-376,
#: global.H:29-200)
_IGNORED_GLOBAL_KEYS = {
    "nthrds", "cuda", "use_cuda", "ngpus", "cuda_prof", "ldlibdir",
    "barrier_check", "barrier_debug", "barrier_extra", "barrier_label",
    "barrier_light", "barrier_quiet", "barrier_verbose",
    "mpi_wait", "main_wait", "debug_wait", "gdb_trace", "traceback",
    "fpe_wait", "PFbufsz", "ratefile", "nbalance", "dbthresh",
    "posnsync", "omp_report",
}
_GLOBAL_KEYS |= _IGNORED_GLOBAL_KEYS | {"fpe_trap", "fpe_trace"}

_COMPONENT_KEYS = {"name", "parameters", "bodyfile", "force"}
_FORCE_KEYS = {"id", "parameters"}
_OUTPUT_KEYS = {"id", "parameters"}

#: force ids the framework knows (grows as forces land); mirrors the factory
#: list in the reference (Component.cc:1077-1108)
KNOWN_FORCES = {
    "sphereSL", "bessel", "cube", "slabSL", "cylinder", "flatdisk",
    "CBDisk", "direct", "noforce", "shells", "halobulge", "twocenter",
    "CBsphere", "hernq",
}

KNOWN_OUTPUTS = {
    "outlog", "outcoef", "outchkpt", "outchkptq", "outpsn", "outascii", "outmulti",
    "outvel", "outsamp", "orbtrace", "outdiag", "outfrac", "outcalbr",
    "outps", "outhdf5", "outspl", "outpsp", "outpsq", "outpsr",
}


@dataclass
class GlobalConfig:
    dtime: float = 0.01
    nsteps: int = 100
    runtag: str = "run0"
    multistep: int = 0
    outdir: str = "."
    infile: str | None = None
    VERBOSE: int = 0
    dynfracV: float = 0.01
    dynfracA: float = 0.03
    dynfracP: float = 0.05
    dynfracS: float = 1.0
    dynfracD: float = 1.0e32
    allcouples: bool = True
    shiftlevl: int = 0
    #: re-level/re-bucket every N big steps (1 = every boundary, the
    #: reference's per-substep adjust is already coarsened to boundaries
    #: by the NoSwitch discipline; >1 trades level freshness for less
    #: relevel overhead)
    nrelevel: int = 1
    #: chain the 2^multistep substeps into one compiled big step (fewer
    #: dispatches per step; longer one-time compile)
    fused_bigstep: bool = False
    #: multistep bucket-capacity slack: <=1 = next-pow2 (legacy), >=2 =
    #: (1 + 0.15*headroom) on a pow2/8 grid.  Runs that migrate many
    #: particles across levels (disk transients) want >=4: every
    #: capacity overflow re-buckets on the host and recompiles all
    #: 2^multistep substep graphs (measured ~15 s/bigstep of thrash vs
    #: ~0.1 s at headroom 4 on the 1M composite's bar transient —
    #: doc/benchmarks.md operational note)
    cap_headroom: int = 1
    compute_dtype: str = "float32"
    accum_dtype: str = "float64"
    #: hard cap on bodies per component (reference global.H nbodmax);
    #: 0 = unlimited
    nbodmax: int = 0
    #: NaN guard (the reference's fpe_trap/fpe_trace + bad_values(),
    #: expand.cc:315-317, ComponentContainer.cc:1596):
    #:   false  — off
    #:   true   — scan diagnostics + coefficients after each block; abort
    #:            with a diagnostic checkpoint on non-finite values
    #:   trace  — in exp_tpu also jax_debug_nans (raise AT the faulting
    #:            op); here the same guard as true
    fpe: bool | str = False
    #: multistep sanity stop: if more than this fraction of a component's
    #: particles request a timestep below the finest level, checkpoint and
    #: stop the run (reference max_mindt, global.cc:21, multistep.cc:296-341)
    maxMindt: float = 0.05
    #: wall-clock budget in HOURS (<0 = off); the run checkpoints and stops
    #: before exceeding it, then launches restart_cmd (chkTimer.cc:38-62)
    runtime: float = -1.0
    #: shell command launched after a wall-clock stop (expand.cc:564-570)
    restart_cmd: str = ""
    #: print a one-line progress report every nreport steps (global.H:56)
    nreport: int = 0
    #: seed for host-side stochastic machinery (scatterMFP, relaxation,
    #: subsampling); reference seeds random_gen per rank (parse.cc:115-121)
    random_seed: int = 11
    #: false = freeze the phase space (no drift/kick; forces and outputs
    #: still evaluated) — the reference's eqmotion toggle (incpos.cc:75,
    #: incvel.cc:93)
    eqmotion: bool = True
    #: with infile: read the checkpoint bodies but start a NEW run at
    #: t=0 with fresh outputs (reference ignore_info, parse.cc:243)
    restart_as_new: bool = False
    #: process niceness applied at startup (parse.cc:100)
    NICE: int = 0
    #: address-space rlimit in GB (0 = leave, <0 = unlimited;
    #: expand.cc:132-142)
    rlimit: int = 0
    #: resolve outdir against the current working directory (parse.cc:123)
    use_cwd: bool = False
    #: explicit home directory prefix for outdir (parse.cc:231-234)
    homedir: str = ""
    #: multistep level whose substeps update tracked centers; <0 means
    #: multistep/2 (ComponentContainer.cc:42-45).  COM centers are
    #: recomputed exactly at every substep, so this staleness knob is
    #: parsed for config compatibility and has no effect.
    centerlevl: int = -1



@dataclass
class ForceConfig:
    id: str
    parameters: dict = field(default_factory=dict)


@dataclass
class ComponentConfig:
    name: str
    bodyfile: str | None
    force: ForceConfig
    parameters: dict = field(default_factory=dict)


@dataclass
class OutputConfig:
    id: str
    parameters: dict = field(default_factory=dict)


@dataclass
class RunConfig:
    glob: GlobalConfig
    components: list[ComponentConfig]
    outputs: list[OutputConfig]
    external: list[dict] = field(default_factory=list)
    interactions: list[tuple[str, str]] = field(default_factory=list)

    @classmethod
    def from_file(cls, path) -> "RunConfig":
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f)
        return cls.from_dict(raw, where=str(path))

    @classmethod
    def from_dict(cls, raw: dict, where: str = "<dict>") -> "RunConfig":
        if raw is None:
            raise ConfigError(f"{where}: empty config")
        allowed_top = {"Global", "Components", "Output", "External",
                       "Interaction"}
        _check_keys(raw, allowed_top, where)

        graw = raw.get("Global") or {}
        _check_keys(graw, _GLOBAL_KEYS, "Global")
        gkw = {k: v for k, v in graw.items()
               if k in GlobalConfig.__dataclass_fields__}
        # reference FPE flags map onto the unified `fpe` knob
        # (expand.cc:315-317): trap -> scan-and-abort, trace -> debug-nans
        if "fpe" not in gkw:
            if graw.get("fpe_trace"):
                gkw["fpe"] = "trace"
            elif graw.get("fpe_trap"):
                gkw["fpe"] = True
        # coerce scalars to the declared field types: YAML 1.1 parses
        # exponents without a sign ("1.0e30") as strings, and int-typed
        # fields may arrive as "100" from templated configs
        for k, v in list(gkw.items()):
            ftype = GlobalConfig.__dataclass_fields__[k].type
            try:
                if ftype == "float" and not isinstance(v, float):
                    gkw[k] = float(v)
                elif ftype == "int" and not isinstance(v, (int, bool)):
                    gkw[k] = int(v)
            except (TypeError, ValueError):
                raise ConfigError(f"Global.{k}: cannot parse {v!r} as {ftype}")
        # tolerated-but-ignored legacy keys (nthrds, cuda, ...)
        glob = GlobalConfig(**gkw)

        comps = []
        for i, c in enumerate(raw.get("Components") or []):
            _check_keys(c, _COMPONENT_KEYS, f"Components[{i}]")
            fraw = c.get("force") or {}
            _check_keys(fraw, _FORCE_KEYS, f"Components[{i}].force")
            fid = fraw.get("id")
            if fid not in KNOWN_FORCES:
                raise ConfigError(
                    f"Components[{i}]: unknown force id {fid!r}; "
                    f"known: {sorted(KNOWN_FORCES)}")
            comps.append(ComponentConfig(
                name=c.get("name", f"comp{i}"),
                bodyfile=c.get("bodyfile"),
                parameters=c.get("parameters") or {},
                force=ForceConfig(id=fid,
                                  parameters=fraw.get("parameters") or {}),
            ))
        if not comps:
            raise ConfigError(f"{where}: no Components")

        outs = []
        for i, o in enumerate(raw.get("Output") or []):
            _check_keys(o, _OUTPUT_KEYS, f"Output[{i}]")
            oid = o.get("id")
            if oid not in KNOWN_OUTPUTS:
                raise ConfigError(f"Output[{i}]: unknown output id {oid!r}; "
                                  f"known: {sorted(KNOWN_OUTPUTS)}")
            outs.append(OutputConfig(id=oid, parameters=o.get("parameters") or {}))

        inter = []
        for item in (raw.get("Interaction") or []) if isinstance(
                raw.get("Interaction"), list) else []:
            if isinstance(item, dict):
                for a, b in item.items():
                    inter.append((a, b))

        return cls(glob=glob, components=comps, outputs=outs,
                   external=raw.get("External") or [],
                   interactions=inter)

    def dump(self, path):
        """Echo the parsed parameters (write_parm analogue, begin.cc:142)."""
        import dataclasses

        import yaml

        def todict(x):
            if dataclasses.is_dataclass(x):
                return {k: todict(v) for k, v in dataclasses.asdict(x).items()}
            return x

        with open(path, "w") as f:
            yaml.safe_dump({
                "Global": todict(self.glob),
                "Components": [todict(c) for c in self.components],
                "Output": [todict(o) for o in self.outputs],
                "External": list(self.external),
                "Interaction": [{a: b} for a, b in self.interactions],
            }, f, sort_keys=False)
