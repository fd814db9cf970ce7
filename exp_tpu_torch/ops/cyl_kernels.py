"""EOF cylinder coefficient (K4) and force (K5) passes: CUDA kernels for
Hopper, their plain PyTorch versions, and the host glue around them.

Port of exp_tpu/ops/pallas_cylinder.py, for pallas_interp 'spline' (the
default) and 'linear':

  K4 `cyl_coef`   replaces make_cyl_coef_kernel   (csrc/cyl_coef.cu)
  K5 `cyl_accel`  replaces make_cyl_accel_kernel  (csrc/cyl_accel.cu)

The kernels read x (N, 3) and mass (N,) as they are and mask their own
ragged tail: the TPU's transposed (8, N) layout, its 1024-particle padding,
its 16-row trig block and its lane padding of the y axis to 128 are not
carried over.  A particle touches at most 3 x nodes ('spline'; 2 for
'linear') and 2 y nodes (y is always hat-interpolated), and both the
kernels and the plain versions touch only those, where the TPU multiplied
dense weight matrices.

Layouts: G keeps the JAX layout (xrows, 2(M+1), ncy), without the TPU's
padding of the trig rows to 16; the coefficients are (2, M+1, nmax).  The
force kernel's contracted table is the port's own, Ct (xrows, ncy, SP):
one contiguous row of SP = 6(M+1) rounded up to 4 floats per node, in
float4 columns of one or two m each (table_columns), so a group of K5's
lanes reads a node as SP/4 consecutive 16-byte loads (the TPU's was
(ncx * Sp, ncyp)).

Each wrapper takes its plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  `launch_counts` counts kernel
launches, one per wrapper call that reaches the card.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch

from exp_tpu_torch.ops import _build
from exp_tpu_torch.ops.spline import b2

#: launches of each kernel since the last reset (only kernel launches count)
launch_counts = {"cyl_coef": 0, "cyl_accel": 0}

#: the mmax values the kernels are instantiated for (2(M+1) <= 16 trig rows,
#: as the TPU kernels assert)
KERNEL_MMAX = range(0, 8)

INTERPS = ("spline", "linear")


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# host packing helpers (once per force, or once per step for the contractions)
# ---------------------------------------------------------------------------

def resample_coarse_x(table, numx, ncx):
    """Linearly resample a (numx, numy, M+1, nmax) table onto ncx evenly
    spaced x-nodes spanning the same [xmin, xmax] (host-side, once)."""
    t = np.linspace(0.0, numx - 1.0, ncx)
    i0 = np.minimum(t.astype(np.int64), numx - 2)
    f = (t - i0).reshape(-1, 1, 1, 1)
    a = np.asarray(table, np.float32)
    return a[i0] * (1.0 - f) + a[i0 + 1] * f


def coarse_dxc(numx, ncx, dx):
    return (numx - 1.0) * dx / (ncx - 1.0)


def coarse_table_stack(potc, rfrcc, zfrcc, device=None):
    """The coarse pot, dU/dR and dU/dz tables (each (xrows, ncy, M+1,
    nmax)) stacked once into one f32 tensor (3, xrows * ncy, M+1, nmax):
    per table, rows are the grid nodes, the operand of both contractions
    below."""
    a = np.stack([np.asarray(t, np.float32) for t in (potc, rfrcc, zfrcc)])
    q, X, Y, M1, nn = a.shape
    return torch.as_tensor(a.reshape(q, X * Y, M1, nn), device=device)


def table_row_width(mmax):
    """SP: the 6(M+1) values of a contracted-table node, rounded up to a
    multiple of 4 floats."""
    return (6 * (mmax + 1) + 3) // 4 * 4


def table_columns(mmax) -> np.ndarray:
    """(6(M+1),) int64: the column of a contracted-table node row that
    holds value q (M+1) + m of the JAX order (q over pot.c, pot.s,
    dUdR.c, dUdR.s, dUdz.c, dUdz.s).  Float4 column m <= M holds (pot.c,
    pot.s, dUdR.c, dUdR.s) of m, float4 column M+1+j (dUdz.c, dUdz.s) of
    m = 2j and 2j+1: each column's values share one or two trig pairs,
    which K5's lanes multiply.  The other columns are zero."""
    M1 = mmax + 1
    q = np.arange(6)[:, None]
    m = np.arange(M1)[None, :]
    return np.where(q < 4, 4 * m + q, 4 * M1 + 2 * m + (q - 4)).reshape(-1)


def contract_coef_tables(coef, tab3, xrows, ncy):
    """coef (2, M+1, nmax) x the stacked coarse tables (coarse_table_stack)
    -> Ct (xrows, ncy, SP) f32 for the force kernel, node (jx, jy) holding
    the values of pot, dUdR and dUdz x cos, sin at the columns of
    table_columns and zeros elsewhere.

    One FP32 matmul of the (3 * nodes, (M+1) nmax) tables with the
    block-diagonal (M+1) nmax x 2(M+1) coefficient matrix, the JAX xla
    path's formulation: one well-shaped GEMM, where a batched per-m product
    with 2 output columns ran as a slow batched GEMV.  On CUDA it runs with
    TF32 off (set by CylinderForce for a CUDA device)."""
    _, G, M1, nn = tab3.shape
    b = coef.to(torch.float32)
    eye = torch.eye(M1, dtype=b.dtype, device=b.device)
    # B[(m, n), cs * M1 + m'] = b[cs, m, n] delta(m, m')
    B = (b.permute(1, 2, 0)[:, :, :, None] * eye[:, None, None, :])
    C = tab3.reshape(3 * G, M1 * nn) @ B.reshape(M1 * nn, 2 * M1)
    C = C.reshape(3, G, 2 * M1).permute(1, 0, 2).reshape(G, 6 * M1)
    SP = table_row_width(M1 - 1)
    src = np.full(SP, 6 * M1)                 # the zero column past C's
    src[table_columns(M1 - 1)] = np.arange(6 * M1)
    C = torch.nn.functional.pad(C, (0, 1))
    return C[:, torch.as_tensor(src, device=C.device)].reshape(xrows, ncy, SP)


def contract_coef_output(G, tab3):
    """G (xrows, 2(M+1), ncy) raw MTTKRP sums x the coarse pot table (first
    of coarse_table_stack) -> (2, M+1, nmax) f32 coefficients with -4 pi:
    one FP32 matmul over the grid nodes, then the matching-m diagonal."""
    _, nodes, M1, nn = tab3.shape
    Gt = G.to(torch.float32).permute(1, 0, 2).reshape(2 * M1, nodes)
    big = (Gt @ tab3[0].reshape(nodes, M1 * nn)).reshape(2, M1, M1, nn)
    m = torch.arange(M1, device=G.device)
    return -4.0 * math.pi * big[:, m, m, :]


@dataclass(frozen=True)
class CylKernelParams:
    """Static geometry of the cylinder kernels (exp_tpu's kernel-maker
    arguments): ncx coarse x nodes from xmin at spacing dxc, ncy y nodes
    from ymin at spacing dy, the maps x = (R/acyl - 1)/(R/acyl + 1) and
    y = asinh(z/hcyl), the table sphere rmax_grid, and the x interpolation
    ('spline' or 'linear')."""

    mmax: int
    ncx: int
    ncy: int
    acyl: float
    hcyl: float
    xmin: float
    dxc: float
    ymin: float
    dy: float
    rmax_grid: float
    interp: str = "spline"

    @property
    def xrows(self):
        return self.ncx + 2 if self.interp == "spline" else self.ncx

    @property
    def trig_rows(self):
        return 2 * (self.mmax + 1)

    @property
    def row_width(self):
        return table_row_width(self.mmax)


# ---------------------------------------------------------------------------
# plain PyTorch versions (the same math in gather / index_add_ form)
# ---------------------------------------------------------------------------

def _cyl_maps(x, y, z, eps=1e-12):
    R = torch.sqrt(x * x + y * y) + eps
    r = torch.sqrt(R * R + z * z) + eps
    return R, r, x / R, y / R


def _grid_coords(R, z, prm):
    """Grid positions (tx, ty), each division rounded as the kernels' (on
    CUDA an ulp of u = z / hcyl is enough: the TPU's arcsinh below cancels
    for z < 0, and F_z flips sign across the midplane within one y cell)."""
    div = _build.div_f32
    xg = (div(R, prm.acyl) - 1.0) / (div(R, prm.acyl) + 1.0)
    u = div(z, prm.hcyl)
    yg = torch.log(u + torch.sqrt(u * u + 1.0))           # the TPU's arcsinh
    tx = torch.clamp(div(xg - prm.xmin, prm.dxc), 0.0, prm.ncx - 1.0)
    ty = torch.clamp(div(yg - prm.ymin, prm.dy), 0.0, prm.ncy - 1.0)
    return tx, ty


def _trig_rows(mmax, cphi, sphi):
    c = [torch.ones_like(cphi)]
    s = [torch.zeros_like(sphi)]
    for _ in range(mmax):
        c.append(c[-1] * cphi - s[-1] * sphi)
        s.append(s[-1] * cphi + c[-2] * sphi)
    return c, s


def _hat_nodes(t, n):
    """Rows floor(t), floor(t) + 1 and their hats max(0, 1 - |j - t|); a
    row past n - 1 gets weight 0 and an index held in range."""
    i0 = torch.clamp(torch.floor(t), max=n - 1.0)
    js, ws = [], []
    for k in range(2):
        j = i0 + k
        w = torch.clamp(1.0 - torch.abs(j - t), min=0.0)
        ws.append(torch.where(j < n, w, torch.zeros_like(w)))
        js.append(torch.clamp(j, max=n - 1.0).long())
    return js, ws


def _x_nodes(tx, prm):
    """The nonzero x weights and their table rows (3 for 'spline', 2 for
    'linear'); the kernel's cyl::x_weights."""
    if prm.interp == "linear":
        return _hat_nodes(tx, prm.ncx)
    c = torch.clamp(torch.floor(tx + 1.5), 1.0, float(prm.ncx))
    js = [c - 1.0 + k for k in range(3)]
    return [j.long() for j in js], [b2(j - 1.0 - tx) for j in js]


def cyl_coef_plain(x, mass, prm: CylKernelParams, chunk: int = 65536):
    """Plain version of K4: G (xrows, 2(M+1), ncy) f32 raw MTTKRP sums of
    particles x (N, 3), mass (N,), by index_add_ over each particle's
    nonzero (x, y) nodes.  The f32 terms are summed in f64 and G rounded to
    f32 once: f32 sums of many rows into one node err by ~1e-5 of max|G|
    on a disk whose rows crowd a few nodes (262,144 Zang rows), as much as
    the tolerance K4 is held to against this version, while K4's exact
    fixed-point sums of the same terms err by ~2e-7."""
    T, ncy = prm.trig_rows, prm.ncy
    G = torch.zeros((prm.xrows * ncy, T), dtype=torch.float64,
                    device=x.device)
    for s in range(0, x.shape[0], chunk):
        xs = x[s:s + chunk].to(torch.float32)
        m = mass[s:s + chunk].to(torch.float32)
        R, r, cphi, sphi = _cyl_maps(xs[:, 0], xs[:, 1], xs[:, 2])
        w = torch.where(r <= prm.rmax_grid, m, torch.zeros_like(m))
        cm, sm = _trig_rows(prm.mmax, cphi, sphi)
        WT = torch.stack([w * c for c in cm] + [w * sn for sn in sm], dim=1)
        tx, ty = _grid_coords(R, xs[:, 2], prm)
        jx, wx = _x_nodes(tx, prm)
        jy, wy = _hat_nodes(ty, ncy)
        for ja, wa in zip(jx, wx):
            A = wa[:, None] * WT                      # Wx * (w trig), as the TPU
            for jb, wb in zip(jy, wy):
                G.index_add_(0, ja * ncy + jb,
                             (A * wb[:, None]).to(torch.float64))
    return G.to(torch.float32).reshape(prm.xrows, ncy, T).permute(
        0, 2, 1).contiguous()


def cyl_accel_plain(x, Ct, prm: CylKernelParams, chunk: int = 65536):
    """Plain version of K5: (acc (N, 3), pot (N,)) f32 at x (N, 3) from the
    contracted table Ct (xrows, ncy, SP), by gathering each particle's
    nonzero (x, y) nodes."""
    accs, pots = [], []
    for s in range(0, x.shape[0], chunk):
        a, p = _accel_chunk_plain(x[s:s + chunk].to(torch.float32), Ct, prm)
        accs.append(a)
        pots.append(p)
    if not accs:
        return (torch.empty((0, 3), dtype=torch.float32, device=x.device),
                torch.empty((0,), dtype=torch.float32, device=x.device))
    return torch.cat(accs), torch.cat(pots)


def _accel_chunk_plain(xs, Ct, prm):
    M1 = prm.mmax + 1
    ncy = prm.ncy
    cols = torch.as_tensor(table_columns(prm.mmax), device=Ct.device)
    flat = Ct.reshape(prm.xrows * ncy, -1)[:, cols]          # JAX order
    x, y, z = xs[:, 0], xs[:, 1], xs[:, 2]
    R, r, cphi, sphi = _cyl_maps(x, y, z)
    outside = r > prm.rmax_grid
    shrink = torch.where(outside, r.new_tensor(prm.rmax_grid) / r,
                         torch.ones_like(r))
    tx, ty = _grid_coords(R * shrink, z * shrink, prm)
    jx, wx = _x_nodes(tx, prm)
    (j0, j1), (w0, w1) = _hat_nodes(ty, ncy)
    v = torch.zeros((xs.shape[0], 6 * M1), dtype=torch.float32,
                    device=xs.device)
    for ja, wa in zip(jx, wx):
        # (Ct @ Wy) then the x-weighted sum, as the TPU kernel
        d = w0[:, None] * flat[ja * ncy + j0] + w1[:, None] * flat[ja * ncy + j1]
        v = v + wa[:, None] * d

    cm, sm = _trig_rows(prm.mmax, cphi, sphi)
    pot = torch.zeros_like(x)
    FR = torch.zeros_like(x)
    Fz = torch.zeros_like(x)
    Fp = torch.zeros_like(x)
    for mm in range(M1):
        cmn, smn = v[:, mm], v[:, M1 + mm]
        pot = pot + (cmn * cm[mm] + smn * sm[mm])
        FR = FR - (v[:, 2 * M1 + mm] * cm[mm] + v[:, 3 * M1 + mm] * sm[mm])
        Fz = Fz - (v[:, 4 * M1 + mm] * cm[mm] + v[:, 5 * M1 + mm] * sm[mm])
        if mm:
            Fp = Fp + mm * (cmn * sm[mm] - smn * cm[mm])
    Fp = Fp / R

    # monopole continuation beyond the table sphere: Phi -> Phi_b r_b/r
    pot_out = pot * shrink
    Fr_out = pot * shrink / r
    ax = torch.where(outside, Fr_out * x / r, FR * cphi - Fp * sphi)
    ay = torch.where(outside, Fr_out * y / r, FR * sphi + Fp * cphi)
    az = torch.where(outside, Fr_out * z / r, Fz)
    pot = torch.where(outside, pot_out, pot)
    return torch.stack([ax, ay, az], dim=1), pot


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong


def _check_prm(prm):
    if prm.mmax not in KERNEL_MMAX:
        raise ValueError(f"mmax={prm.mmax}: the cylinder kernels are built "
                         f"for mmax {KERNEL_MMAX.start}..{KERNEL_MMAX.stop - 1}")
    if prm.interp not in INTERPS:
        raise ValueError(f"interp={prm.interp!r}: expected one of {INTERPS}")


def _geometry_args(prm):
    return (1 if prm.interp == "spline" else 0, prm.mmax, prm.ncx, prm.ncy,
            prm.acyl, prm.hcyl, prm.xmin, prm.dxc, prm.ymin, prm.dy,
            prm.rmax_grid)


#: K4's launch plan: at least this many particles a chunk (a block's fixed
#: cost, zeroing its accumulator and writing its rows, then stays a small
#: share of its time)
K4_MIN_CHUNK = 2048
#: K4's largest block
K4_MAX_WARPS = 24


@dataclass(frozen=True)
class CylCoefPlan:
    """K4's launch: `groups` groups of at most `tg` of the 2M+1 nonzero trig
    rows, `nw` warps a block, `chunks` particle chunks (grid (chunks,
    groups)), `ncyp` the shared accumulator's row stride (ncy rounded up to
    2 mod 32) and `smem` bytes of shared memory a block."""

    tg: int
    groups: int
    nw: int
    chunks: int
    ncyp: int
    smem: int


def k4_record_words(kx, tg):
    """Words of a staged particle record in csrc/cyl_coef.cu: its base
    offset and its kx * 2 * tg fixed-point updates, rounded up to odd."""
    return (1 + 2 * kx * tg) | 1


def coef_plan(n, prm: CylKernelParams, sm_count, smem_optin) -> CylCoefPlan:
    """K4's launch plan for n particles on a device of `sm_count` SMs and
    `smem_optin` bytes of shared memory a block, as csrc/cyl_coef.cu lays
    it out.  The fewest row groups whose rows' accumulator (xrows, tg,
    ncyp) i32 and at least 4 warps (a sum and 32 records each) fit, with a
    particle's kx * 2 * tg updates on at most 32 lanes; as many warps (at
    most K4_MAX_WARPS) as the rest holds; chunks of at least K4_MIN_CHUNK
    particles, at most one block an SM.  Raises ValueError when not even
    one trig row fits."""
    R = 2 * prm.mmax + 1
    kx = 3 if prm.interp == "spline" else 2
    ncyp = prm.ncy + (2 - prm.ncy) % 32
    for groups in range(-(-R // min(R, 32 // (2 * kx))), R + 1):
        tg = -(-R // groups)
        acc = 4 * prm.xrows * tg * ncyp
        warp_bytes = 4 + 4 * 32 * k4_record_words(kx, tg)
        nw = min(K4_MAX_WARPS, (smem_optin - acc) // warp_bytes)
        if nw >= 4:
            break
    else:
        raise ValueError(f"cyl_coef: one trig row of G ({prm.xrows} x "
                         f"{ncyp} i32) and 4 warps' stage exceed a block's "
                         f"{smem_optin} bytes of shared memory")
    chunks = max(1, min(n // K4_MIN_CHUNK, sm_count // groups))
    return CylCoefPlan(tg, groups, nw, chunks, ncyp, acc + nw * warp_bytes)


def cyl_coef(x, mass, prm: CylKernelParams):
    """K4: G (xrows, 2(M+1), ncy) f32 raw MTTKRP sums.

    x (N, 3), mass (N,), f32.  CPU tensors take cyl_coef_plain; CUDA
    tensors launch csrc/cyl_coef.cu with the plan of coef_plan."""
    _check_prm(prm)
    if x.device.type == "cpu":
        return cyl_coef_plain(x, mass, prm)
    if x.device.type != "cuda":
        raise ValueError(f"cyl_coef: unsupported device {x.device}")
    n = x.shape[0]
    dev = x.device
    _build.check_tensor(x, "x", (n, 3), dev)
    _build.check_tensor(mass, "mass", (n,), dev)
    fn, err = _build.bind("cyl_coef", [_P, _P, _LL, _P, _P, _I, _I, _I, _I,
                                       _I, _I, _I, _I, _I, _F, _F, _F, _F,
                                       _F, _F, _F, _P])
    props = torch.cuda.get_device_properties(dev)
    plan = coef_plan(n, prm, props.multi_processor_count,
                     props.shared_memory_per_block_optin)
    T = prm.trig_rows
    G = torch.empty((prm.xrows, T, prm.ncy), dtype=torch.float32, device=dev)
    partial = None
    if plan.chunks > 1:
        partial = torch.empty((plan.chunks, prm.xrows, T - 1, prm.ncy),
                              dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(x.data_ptr(), mass.data_ptr(), n,
                  None if partial is None else partial.data_ptr(),
                  G.data_ptr(), plan.tg, plan.groups, plan.nw, plan.chunks,
                  plan.ncyp, *_geometry_args(prm), stream)
    _build.raise_on(code, err, "cyl_coef")
    launch_counts["cyl_coef"] += 1
    return G


#: K5's lanes (threads) a particle and threads a block (csrc/cyl_accel.cu
#: kLanes, kThreads), and the lanes a SM up to which each lane sets its
#: particle up itself; past it, one thread a particle sets it up and
#: broadcasts it to the particle's lanes
K5_LANES = 4
K5_THREADS = 256
K5_LANES_PER_SM = 2048


@dataclass(frozen=True)
class CylAccelPlan:
    """K5's launch: `lanes` threads a particle's column work, `broadcast`
    (one thread a particle's set-up, shared with its lanes by shuffles)
    or not (each lane sets the particle up), `blocks` blocks of K5_THREADS
    threads and `smem` bytes of shared memory a block (0: the table is
    read through L1, all of which stays free to cache it)."""

    lanes: int
    broadcast: bool
    blocks: int
    smem: int


def accel_plan(n, prm: CylKernelParams, sm_count, smem_optin,
               broadcast=None) -> CylAccelPlan:
    """K5's launch plan for n particles on a device of `sm_count` SMs:
    K5_LANES threads a particle's column work at every size; the set-up
    broadcast once the n particles' lanes pass K5_LANES_PER_SM a SM
    (`broadcast` sets it instead); the blocks that cover the rows, no
    more.  Both forms give the same bits.  K5 takes no shared memory
    (`prm` and `smem_optin` change nothing)."""
    if broadcast is None:
        broadcast = n * K5_LANES > K5_LANES_PER_SM * sm_count
    per_block = K5_THREADS if broadcast else K5_THREADS // K5_LANES
    return CylAccelPlan(K5_LANES, bool(broadcast), -(-n // per_block), 0)


def cyl_accel(x, Ct, prm: CylKernelParams, plan=None):
    """K5: cylinder force (acc (N, 3), pot (N,)) f32.

    x (N, 3), Ct (xrows, ncy, SP) from contract_coef_tables; f32.  CPU
    tensors take cyl_accel_plain; CUDA tensors launch csrc/cyl_accel.cu
    with `plan`, by default accel_plan's."""
    _check_prm(prm)
    if x.device.type == "cpu":
        return cyl_accel_plain(x, Ct, prm)
    if x.device.type != "cuda":
        raise ValueError(f"cyl_accel: unsupported device {x.device}")
    n = x.shape[0]
    dev = x.device
    _build.check_tensor(x, "x", (n, 3), dev)
    _build.check_tensor(Ct, "Ct", (prm.xrows, prm.ncy, prm.row_width), dev)
    if Ct.data_ptr() % 16:
        raise ValueError("Ct must be 16-byte aligned")
    fn, err = _build.bind("cyl_accel", [_P, _LL, _P, _P, _P, _I, _I, _I, _I,
                                        _I, _I, _F, _F, _F, _F, _F, _F, _F,
                                        _P])
    if plan is None:
        props = torch.cuda.get_device_properties(dev)
        plan = accel_plan(n, prm, props.multi_processor_count,
                          props.shared_memory_per_block_optin)
    acc = torch.empty((n, 3), dtype=torch.float32, device=dev)
    pot = torch.empty((n,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(x.data_ptr(), n, Ct.data_ptr(), acc.data_ptr(),
                  pot.data_ptr(), int(plan.broadcast), plan.blocks,
                  *_geometry_args(prm), stream)
    _build.raise_on(code, err, "cyl_accel")
    launch_counts["cyl_accel"] += 1
    return acc, pot
