"""Multi-process execution over torch.distributed (port of
exp_tpu/parallel/distributed.py; the reference's MPI machinery,
src/expand.cc:184-187 MPI_Init, Component.H:202-204's particle
distribution and its rank-0-gated output).

One process per device.  `init_distributed` joins the world from
EXP_COORDINATOR / EXP_NPROCS / EXP_PROCID, as exp_tpu reads them, or from
torch's own env:// variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK)
where those are unset.  The backend is NCCL between cards and gloo on the
CPU; gloo also serves several ranks on one card, which NCCL refuses.

Collectives.  Every global quantity is an all-reduce (SUM).  What a rank
gathers (the writers' phase space, the direct ring's sources, EJ's
candidates) is an all-reduce of a zero-padded buffer in which each rank
fills its own rows: x + 0 is x, so the sum is the concatenation, and it
runs on every backend and device.  Under gloo the collectives run on host
tensors (gloo's CUDA support is all_reduce, broadcast and barrier only);
under NCCL on the rank's card.  Tables built on the host go from rank 0 to
the others by `broadcast` of their pickled bytes: the other ranks never
build (the reference builds SL tables on a subset of ranks and broadcasts
them, SLGridMP2.cc:280-382).
"""

from __future__ import annotations

import datetime
import os
import pickle
from dataclasses import dataclass

import numpy as np
import torch

from exp_tpu_torch.nbody.particles import ParticleSystem

#: seconds a collective waits for the other ranks before it fails the run
DEFAULT_TIMEOUT = 900.0

_WORLD = None


@dataclass
class World:
    """A rank's view of the process group: the counterpart of exp_tpu's
    particle mesh.  `group` None is the default group."""

    rank: int = 0
    size: int = 1
    device: torch.device = torch.device("cpu")
    backend: str | None = None
    group: object = None

    @property
    def is_primary(self) -> bool:
        return self.rank == 0

    @property
    def comm_device(self) -> torch.device:
        """Where the collectives run: the rank's card under NCCL, the host
        under gloo."""
        return self.device if self.backend == "nccl" else torch.device("cpu")


def current_world():
    """The world `init_distributed` joined in this process, or None."""
    return _WORLD


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, device=None,
                     backend: str | None = None,
                     timeout: float | None = None) -> World:
    """Join the multi-process world (expand.cc:184-187 MPI_Init analogue)
    and return this rank's World.

    coordinator "host:port" (EXP_COORDINATOR), the world size
    (EXP_NPROCS) and this process's rank (EXP_PROCID) default to the
    environment; with none of them set, torch's env:// variables are read.
    device: this rank's device (default: card `LOCAL_RANK` (else the rank)
    modulo the cards present; with no card this raises, as every entry
    point of the port does without a device named).
    backend: EXP_BACKEND, else NCCL on a card and gloo on the CPU."""
    global _WORLD
    import torch.distributed as dist

    coordinator = coordinator or os.environ.get("EXP_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("EXP_NPROCS",
                                           os.environ.get("WORLD_SIZE", 1)))
    if process_id is None:
        process_id = int(os.environ.get("EXP_PROCID",
                                        os.environ.get("RANK", 0)))
    if device is None:
        from exp_tpu_torch import resolve_device

        resolve_device(None)            # raises when there is no card
        local = int(os.environ.get("LOCAL_RANK", process_id))
        device = f"cuda:{local % torch.cuda.device_count()}"
    device = torch.device(device)
    backend = backend or os.environ.get("EXP_BACKEND") or (
        "nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    timeout = float(os.environ.get("EXP_TIMEOUT", DEFAULT_TIMEOUT)
                    if timeout is None else timeout)
    init = f"tcp://{coordinator}" if coordinator else "env://"
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init, world_size=int(num_processes),
            rank=int(process_id),
            timeout=datetime.timedelta(seconds=timeout))
    _WORLD = World(rank=dist.get_rank(), size=dist.get_world_size(),
                   device=device, backend=backend)
    return _WORLD


def finalize_distributed():
    """Leave the world `init_distributed` joined (destroy its process
    group); a no-op when none was joined."""
    global _WORLD
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    _WORLD = None


def is_primary(world=None) -> bool:
    """True on the output-writing rank (the reference's myid == 0)."""
    world = world if world is not None else _WORLD
    return world is None or world.rank == 0


def _size(world) -> int:
    return 1 if world is None else int(world.size)


def all_reduce(t, group=None):
    """The sum of `t` over the ranks of `group` (a World; None or one rank:
    `t` itself).  Runs on the world's communication device and returns a
    tensor on t's device: `t` itself, reduced in place, when the two are
    the same and t is contiguous."""
    if _size(group) == 1:
        return t
    import torch.distributed as dist

    buf = t.to(group.comm_device).contiguous()
    dist.all_reduce(buf, group=group.group)
    return buf.to(t.device)


def world_coefficients(force, x, mass, world=None, **kw):
    """force.coefficients of this rank's rows, summed over the ranks of
    `world` once, after the kernel (exp_tpu's psum over `axis_name`); a
    two-center force's pair leaf by leaf.  A source force's (the direct
    sum's own rows, which its ring passes round) come back as they are."""
    c = force.coefficients(x, mass, **kw)
    if _size(world) == 1 or getattr(force, "needs_sources", False):
        return c

    def red(t):
        return (tuple(red(u) for u in t) if isinstance(t, tuple)
                else all_reduce(t, world))
    return red(c)


def sum_host(values, world=None) -> np.ndarray:
    """Elementwise sum over the ranks of a small host vector (the relevel's
    counts and flags), as float64 or int64 as given."""
    a = np.asarray(values)
    if _size(world) == 1:
        return a
    t = torch.as_tensor(a, device=world.comm_device)
    return all_reduce(t, world).cpu().numpy()


def allgather_rows(t, world=None):
    """The concatenation over ranks (in rank order) of each rank's `t`
    along dim 0, on every rank: an all-reduce of a zero-padded buffer in
    which each rank fills its own rows.  Ranks may hold different row
    counts; the other dims and the dtype must agree.  Returns (tensor on
    t's device, the row counts)."""
    if _size(world) == 1:
        return t, [int(t.shape[0])]
    lens = np.zeros(world.size, np.int64)
    lens[world.rank] = t.shape[0]
    lens = sum_host(lens, world)
    off = int(lens[:world.rank].sum())
    dt = torch.int64 if not t.is_floating_point() else t.dtype
    buf = torch.zeros((int(lens.sum()),) + tuple(t.shape[1:]), dtype=dt,
                      device=world.comm_device)
    buf[off:off + t.shape[0]] = t.to(world.comm_device, dt)
    buf = all_reduce(buf, world)
    return buf.to(t.device, t.dtype), [int(n) for n in lens]


def broadcast_object(obj, world=None, src: int = 0):
    """A picklable object from rank `src` to every rank (its bytes as a
    uint8 tensor: broadcast runs on every backend and device)."""
    if _size(world) == 1:
        return obj
    import torch.distributed as dist

    dev = world.comm_device
    if world.rank == src:
        data = np.frombuffer(pickle.dumps(obj), np.uint8)
        n = torch.tensor([data.size], dtype=torch.int64, device=dev)
    else:
        n = torch.zeros(1, dtype=torch.int64, device=dev)
    dist.broadcast(n, src, group=world.group)
    if world.rank == src:
        buf = torch.as_tensor(data.copy(), device=dev)
    else:
        buf = torch.empty(int(n.item()), dtype=torch.uint8, device=dev)
    dist.broadcast(buf, src, group=world.group)
    if world.rank == src:
        return obj
    return pickle.loads(buf.cpu().numpy().tobytes())


class _BuildFailed:
    """What rank 0 broadcasts in place of tables it failed to build."""

    def __init__(self, msg):
        self.msg = msg


def primary_build(world, build_fn):
    """build_fn() on rank 0 only, its result broadcast to every rank (a
    one-rank world or None: build_fn()).  A failure on rank 0 raises on
    every rank."""
    if _size(world) == 1:
        return build_fn()
    if world.rank == 0:
        try:
            obj = build_fn()
        except Exception as e:
            broadcast_object(_BuildFailed(f"{type(e).__name__}: {e}"), world)
            raise
        return broadcast_object(obj, world)
    obj = broadcast_object(None, world)
    if isinstance(obj, _BuildFailed):
        raise RuntimeError(f"rank {world.rank}: the table build on rank 0 "
                           f"failed ({obj.msg})")
    return obj


def row_block(n_global: int, world=None) -> tuple[int, int]:
    """The contiguous [lo, hi) global row range this rank holds: block
    `rank` of `size` equal blocks (`n_global` a multiple of the size:
    pad_global_count)."""
    k = _size(world)
    if n_global % k:
        raise ValueError(f"{n_global} rows do not split into {k} equal "
                         "blocks: pad with pad_global_count first")
    b = n_global // k
    r = 0 if world is None else world.rank
    return r * b, (r + 1) * b


def pad_global_count(n: int, world=None) -> int:
    """Smallest multiple of the world's size >= n."""
    k = _size(world)
    return ((n + k - 1) // k) * k


def ps_from_local(x, v, mass, world, n_global: int, lo: int, scale=None,
                  dtype=torch.float32, indx=None) -> ParticleSystem:
    """This rank's ParticleSystem, on its device, from its row block
    [lo, lo + len) of a global array of `n_global` rows.  Identities
    default to the 1-based global row number; zero-mass (padding) rows
    carry indx 0."""
    x = np.asarray(x, np.float64).reshape(-1, 3)
    mass = np.asarray(mass, np.float64)
    n_loc = x.shape[0]
    if n_global % _size(world):
        raise ValueError("n_global must be a multiple of the world size")
    ix = (np.arange(lo + 1, lo + n_loc + 1, dtype=np.int64) if indx is None
          else np.asarray(indx, np.int64))
    ix = np.where(mass > 0, ix, 0).astype(np.int32)
    return ParticleSystem.from_arrays(
        x, np.asarray(v, np.float64).reshape(-1, 3), mass, dtype=dtype,
        indx=ix, scale=scale, device=world.device if world else None)


def read_bodies_distributed(path, world, dtype=torch.float32,
                            component: str | None = None,
                            scale_dattr: int | None = None,
                            with_rows: bool = False):
    """Process-sharded body read: each rank parses only its row block of
    an ascii body file (Component.H:202-204's scatter, without the
    scatter); a PSP file is read whole and cut.  The global count is
    padded to a multiple of the world size with zero-mass rows.  Returns
    this rank's ParticleSystem, and with `with_rows` also the file's row
    count (the global rows before the padding)."""
    from exp_tpu_torch import native
    from exp_tpu_torch.nbody.particles import is_psp_file

    if is_psp_file(path):
        from exp_tpu_torch.io.psp import read_psp

        dump = read_psp(path)
        if isinstance(dump, list):
            dump = dump[-1]
        comps = dump.components
        match = [c for c in comps if component is not None
                 and c.name == component]
        if match:
            c = match[0]
        elif len(comps) == 1:
            c = comps[0]
        else:
            raise ValueError(f"{path}: no component named {component!r}")
        xg, vg, mg, ixg = c.x, c.v, c.mass, c.indx
        sg = (c.dattr[:, scale_dattr]
              if scale_dattr is not None and c.dattr is not None else None)
        n = len(mg)
    else:
        with open(path) as f:
            hdr = f.readline().split()
        n, niattrib = int(hdr[0]), int(hdr[1])
        xg = None

    n_global = pad_global_count(n, world)
    lo, hi = row_block(n_global, world)
    lo_live, hi_live = min(lo, n), min(hi, n)
    nl = hi_live - lo_live
    if xg is None:
        xl, vl, ml = np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0)
        sl = np.zeros(0) if scale_dattr is not None else None
        if nl > 0:
            cols = [0, 1, 2, 3, 4, 5, 6]
            if scale_dattr is not None:
                cols.append(7 + niattrib + scale_dattr)
            data = native.read_columns(path, cols, max_rows=nl,
                                       skip_lines=1 + lo_live)
            xl, vl, ml = data[:, 1:4], data[:, 4:7], data[:, 0]
            if scale_dattr is not None:
                sl = data[:, 7]
        ixl = None
    else:
        xl, vl, ml = xg[lo_live:hi_live], vg[lo_live:hi_live], \
            mg[lo_live:hi_live]
        ixl = None if ixg is None else np.asarray(ixg[lo_live:hi_live],
                                                   np.int64)
        sl = None if sg is None else sg[lo_live:hi_live]
    npad = (hi - lo) - nl
    if npad:
        xl = np.concatenate([xl, np.zeros((npad, 3))])
        vl = np.concatenate([vl, np.zeros((npad, 3))])
        ml = np.concatenate([ml, np.zeros(npad)])
        if ixl is not None:
            ixl = np.concatenate([ixl, np.zeros(npad, np.int64)])
        if sl is not None:
            sl = np.concatenate([sl, np.full(npad, -1.0)])
    ps = ps_from_local(xl, vl, ml, world, n_global, lo, dtype=dtype,
                       indx=ixl, scale=sl)
    return (ps, int(n)) if with_rows else ps


_PS_FIELDS = ("x", "v", "mass", "acc", "pot", "level", "indx", "scale")


def allgather_ps(ps: ParticleSystem, world=None) -> ParticleSystem:
    """Every rank's rows of a ParticleSystem, concatenated in rank order,
    as host NumPy arrays on every rank: the pre-write gather of the
    full-phase-space writers (the reference's OutPSN rank gather,
    OutCHKPT.H:17-20).  Collective: every rank must call it."""
    if _size(world) == 1:
        return ParticleSystem(**{k: getattr(ps, k).detach().cpu().numpy()
                                 for k in _PS_FIELDS})
    fl = torch.cat([ps.x, ps.v, ps.acc, ps.mass[:, None], ps.pot[:, None],
                    ps.scale[:, None]], dim=1)
    it = torch.stack([ps.level, ps.indx], dim=1).to(torch.int64)
    fl, _ = allgather_rows(fl, world)
    it, _ = allgather_rows(it, world)
    fl, it = fl.cpu().numpy(), it.cpu().numpy()
    return ParticleSystem(x=fl[:, 0:3], v=fl[:, 3:6], acc=fl[:, 6:9],
                          mass=fl[:, 9], pot=fl[:, 10], scale=fl[:, 11],
                          level=it[:, 0].astype(np.int32),
                          indx=it[:, 1].astype(np.int32))
