"""Periodic-cube coefficient (K7, K11a) and force (K8, K11b) passes: CUDA
kernels for Hopper, their plain PyTorch versions, and the host glue around
them.

Port of exp_tpu/ops/pallas_cube.py:

  K7   `cube_coef`      replaces make_cube_coef_kernel_v2  (csrc/cube_coef.cu)
  K11a `cube_coef`      replaces make_cube_coef_kernel     (the same sums)
  K8   `cube_accel`     replaces make_cube_accel_kernel_v2 (csrc/cube_accel.cu)
  K11b `cube_accel_v1`  replaces make_cube_accel_kernel    (its (R_re, R_im)
                        packing turned into cube_accel's table in glue)

The kernels read x (N, 3) and mass (N,) as they are and mask their own
ragged tail: the TPU's transposed (8, N) layout, its 1024-particle padding,
its selection matrices and its padded 16 x 16 (kx, ky) lattice are not
carried over.

Layouts: the coefficient pass returns the raw sums S[kx, ky, kz] =
sum_i m_i e^{-2 pi i k.u_i} (u = x - floor(x)) as complex64 (2 nmaxx + 1,
2 nmaxy + 1, 2 nmaxz + 1), the JAX kernels' contract; the caller applies
-norm.  The force pass takes the port's own table (cube_force_table): b =
coef * norm folded onto the planes kx >= 0 as f32 (re, im) pairs, which
holds each value once where the TPU's M2 = [[Rr, -Ri], [Ri, Rr]] held it
twice and tripled it into three contraction paths.

Both kernels fold the kz axis into cosines and sines and run the folded
products on the tensor cores as split-TF32 mma.sync (csrc/tf32_mma.cuh);
their launch plans (`coef_plan`, `accel_plan`) are pure arithmetic on the
lattice and the device's figures: the grid, and K8's warps a block, which
depend on the device; each kernel lays out its block itself.

Each wrapper takes its plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  `launch_counts` counts kernel
launches, one per wrapper call that reaches the card.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from exp_tpu_torch.ops import _build

#: launches of each kernel since the last reset (only kernel launches count)
launch_counts = {"cube_coef": 0, "cube_accel": 0}

#: the nmax values per axis the kernels are instantiated for
KERNEL_NMAX = range(0, 9)

_TWO_PI = 2.0 * math.pi

#: K7: particles a staged tile (8 k-steps of m16n8k8), pair groups (8 (kx,
#: ky) pairs) a warp owns (csrc/cube_coef.cu kTile, kGroupsPerWarp), and the
#: warps an SM the grid aims at
K7_TILE = 64
K7_GROUPS_PER_WARP = 3
K7_WARPS_PER_SM = 16
#: K8: particles a warp stages at once (two m-tiles), float2 a staged
#: element (8 mod 16: csrc/cube_accel.cu kPw) and the most warps a block
#: (one block an SM holds the whole folded table)
K8_WARP_TILE = 32
K8_STRIDE = K8_WARP_TILE + 8
K8_MAX_WARPS = 16


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


@dataclass(frozen=True)
class CubeKernelParams:
    """Static geometry of the cube kernels: nmax per axis."""

    nmaxx: int
    nmaxy: int
    nmaxz: int

    @property
    def shape(self):
        """The full lattice (2 nmaxx + 1, 2 nmaxy + 1, 2 nmaxz + 1)."""
        return (2 * self.nmaxx + 1, 2 * self.nmaxy + 1, 2 * self.nmaxz + 1)

    @property
    def half_shape(self):
        """The folded lattice: the planes kx = 0..nmaxx."""
        return (self.nmaxx + 1, 2 * self.nmaxy + 1, 2 * self.nmaxz + 1)


@dataclass(frozen=True)
class CoefPlan:
    """K7's launch: the half (kx, ky) lattice in `pairs` (kx = 0 with ky >=
    0, then kx > 0; they size the block partials), the `warps` a block that
    the kernel runs (each owns up to K7_GROUPS_PER_WARP groups of 8 pairs)
    and `nblocks`."""

    pairs: int
    warps: int
    nblocks: int


def coef_plan(n, prm: CubeKernelParams, sms) -> CoefPlan:
    """K7's launch plan for n particles on a device of `sms` SMs: enough
    blocks for about K7_WARPS_PER_SM warps an SM, or one tile each when n is
    small.  The row-to-block map depends on n only through the count of
    blocks."""
    pairs = (prm.nmaxy + 1) + prm.nmaxx * (2 * prm.nmaxy + 1)
    warps = -(-pairs // (8 * K7_GROUPS_PER_WARP))
    per_sm = max(1, K7_WARPS_PER_SM // warps)
    nblocks = max(1, min(-(-n // K7_TILE), per_sm * sms))
    return CoefPlan(pairs, warps, nblocks)


@dataclass(frozen=True)
class AccelPlan:
    """K8's launch: the folded (kx, ky) `rows` in `groups` of 4, `ks`
    k-steps of 8 kz phases, `elems` staged float2 a particle (its e_x and
    e_y powers and split kz phases), the folded table's `table_bytes` (B
    fragments and row records), a warp's stage `warp_bytes`, `warps` a
    block, `smem` bytes and `nblocks`."""

    rows: int
    groups: int
    ks: int
    elems: int
    table_bytes: int
    warp_bytes: int
    warps: int
    smem: int
    nblocks: int


def accel_plan(n, prm: CubeKernelParams, sms, smem_optin) -> AccelPlan:
    """K8's launch plan for n particles: by the block's layout in
    csrc/cube_accel.cu (geometry(), smem_bytes()), one block an SM with as many warps (up to
    K8_MAX_WARPS) as the shared memory left by the table holds, fewer
    blocks when n is small.  Raises when not even one warp fits."""
    ax, ky, kz = prm.nmaxx + 1, 2 * prm.nmaxy + 1, 2 * prm.nmaxz + 1
    rows = (prm.nmaxy + 1) + prm.nmaxx * ky
    groups = -(-rows // 4)
    ks = -(-kz // 8)
    elems = ax + ky + 8 * ks
    table = 4 * (4 * 32 * 2 * ks * groups + 16 * groups)
    warp = 8 * K8_STRIDE * elems
    warps = min(K8_MAX_WARPS, (smem_optin - table) // warp)
    if warps < 1:
        raise ValueError(f"nmax {(prm.nmaxx, prm.nmaxy, prm.nmaxz)}: K8's "
                         f"table ({table} bytes) leaves no room for a warp in "
                         f"{smem_optin} bytes of shared memory")
    nblocks = max(1, min(sms, -(-n // (warps * K8_WARP_TILE))))
    return AccelPlan(rows, groups, ks, elems, table, warp, warps,
                     table + warps * warp, nblocks)


def check_params(prm: CubeKernelParams) -> None:
    """Raise NotImplementedError for an nmax the kernels are not built for."""
    bad = [n for n in (prm.nmaxx, prm.nmaxy, prm.nmaxz) if n not in KERNEL_NMAX]
    if bad:
        raise NotImplementedError(
            f"nmax {(prm.nmaxx, prm.nmaxy, prm.nmaxz)}: the cube kernels are "
            f"built for nmax {KERNEL_NMAX.start}..{KERNEL_NMAX.stop - 1} on "
            "each axis")


# ---------------------------------------------------------------------------
# host glue
# ---------------------------------------------------------------------------

def wrap(x):
    """u = x - floor(x): positions wrapped into the unit box, floor-based
    as the JAX kernels wrap (never fmod, which keeps the sign of x)."""
    return torch.remainder(x, 1.0)


def axis_phases(u, nmax, sign):
    """e^{sign 2 pi i k u} for k = -nmax..nmax: complex (N, 2 nmax + 1) from
    u (N,), the angle rounded as the JAX kernels round it,
    (sign 2 pi) (k u) in u's dtype (pallas_cube.py:54-72)."""
    k = torch.arange(-nmax, nmax + 1, dtype=u.dtype, device=u.device)
    ang = (sign * _TWO_PI) * (k[None, :] * u[:, None])
    return torch.complex(torch.cos(ang), torch.sin(ang))


def cube_force_table(b, prm: CubeKernelParams):
    """b = coef * norm (complex, the full lattice) -> the force kernel's
    table (nmaxx + 1, 2 nmaxy + 1, 2 nmaxz + 1, 2) f32: the plane kx = 0 as
    it is, and b_k + conj b_{-k} for kx > 0.  Re and Im of the conjugate
    term at k equal those of b_{-k}'s term at -k (with the sign of k for
    Im), so every output of the force pass is unchanged."""
    h = b[prm.nmaxx:].clone()
    if prm.nmaxx:
        h[1:] += torch.conj(b[:prm.nmaxx].flip(0, 1, 2))
    return torch.view_as_real(h.to(torch.complex64)).contiguous()


def pack_force_matrix(b, nmaxx, nmaxy, nmaxz):
    """The v1 TPU packing (pallas_cube.py:244-263): b (Kx, Ky, Kz) complex
    -> (R_re, R_im) (Cp, Sp) f32, columns [b | 2 pi kx b | 2 pi ky b]
    flattened over (kx, ky) rows, each path zero-padded to kzp columns."""
    kx, ky, kz = 2 * nmaxx + 1, 2 * nmaxy + 1, 2 * nmaxz + 1
    C = kx * ky
    Cp = _round_up(C, 8)
    kzp = _round_up(kz, 8)
    dev = b.device
    kxv = (_TWO_PI * torch.arange(-nmaxx, nmaxx + 1, dtype=torch.float32,
                                  device=dev))[:, None, None]
    kyv = (_TWO_PI * torch.arange(-nmaxy, nmaxy + 1, dtype=torch.float32,
                                  device=dev))[None, :, None]
    pad = (0, kzp - kz)
    R = torch.cat([torch.nn.functional.pad(b, pad),
                   torch.nn.functional.pad(b * kxv, pad),
                   torch.nn.functional.pad(b * kyv, pad)], dim=2)
    R = torch.nn.functional.pad(R.reshape(C, 3 * kzp), (0, 0, 0, Cp - C))
    return R.real.to(torch.float32), R.imag.to(torch.float32)


def pack_force_matrix_v2(b, nmaxx, nmaxy, nmaxz):
    """The v2 TPU packing (pallas_cube.py:410-433): b (Kx, Ky, Kz) complex
    -> M2 (2 Sp, 2 Cq) f32, M2 = [[Rr, -Ri], [Ri, Rr]] over the padded
    16 x 16 (kx, ky) lattice.  Kept for the tests, which feed the JAX
    kernels and the port the same b."""
    kx, ky, kz = 2 * nmaxx + 1, 2 * nmaxy + 1, 2 * nmaxz + 1
    kxp, kyp, kzp = _round_up(kx, 8), _round_up(ky, 8), _round_up(kz, 8)
    dev = b.device
    kxv = (_TWO_PI * torch.arange(-nmaxx, nmaxx + 1, dtype=torch.float32,
                                  device=dev))[:, None, None]
    kyv = (_TWO_PI * torch.arange(-nmaxy, nmaxy + 1, dtype=torch.float32,
                                  device=dev))[None, :, None]
    zpad = (0, kzp - kz)
    Rk = torch.cat([torch.nn.functional.pad(b, zpad),
                    torch.nn.functional.pad(b * kxv, zpad),
                    torch.nn.functional.pad(b * kyv, zpad)], dim=2)
    Rk = torch.nn.functional.pad(Rk, (0, 0, 0, kyp - ky, 0, kxp - kx))
    R = Rk.reshape(kxp * kyp, 3 * kzp).T
    Rr, Ri = R.real.to(torch.float32), R.imag.to(torch.float32)
    return torch.cat([torch.cat([Rr, -Ri], dim=1),
                      torch.cat([Ri, Rr], dim=1)], dim=0)


def v1_matrix_to_b(R_re, R_im, prm: CubeKernelParams):
    """b (Kx, Ky, Kz) complex64 back from the v1 packing: path 0 of
    (R_re, R_im), whose other two paths are 2 pi kx b and 2 pi ky b."""
    kx, ky, kz = prm.shape
    C = kx * ky
    return torch.complex(R_re[:C, :kz], R_im[:C, :kz]).reshape(kx, ky, kz)


def _round_up(x, m):
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def cube_coef_plain(x, mass, prm: CubeKernelParams, chunk: int = 65536):
    """Plain version of K7: the raw sums S (Kx, Ky, Kz) complex64 of
    particles x (N, 3), mass (N,), over the full lattice, as the JAX v2
    kernel contracts them: [xyr; xyi] (2C, B) against [m ezr; m ezi]
    (2 kz, B), one f32 matmul a chunk of particles."""
    kx, ky, kz = prm.shape
    C = kx * ky
    acc = torch.zeros((2 * C, 2 * kz), dtype=torch.float32, device=x.device)
    for s in range(0, x.shape[0], chunk):
        u = wrap(x[s:s + chunk].to(torch.float32))
        m = mass[s:s + chunk].to(torch.float32)
        ex = axis_phases(u[:, 0], prm.nmaxx, -1.0)
        ey = axis_phases(u[:, 1], prm.nmaxy, -1.0)
        mez = axis_phases(u[:, 2], prm.nmaxz, -1.0) * m[:, None]
        exy = (ex[:, :, None] * ey[:, None, :]).reshape(-1, C)
        XY = torch.cat([exy.real, exy.imag], dim=1)
        Z = torch.cat([mez.real, mez.imag], dim=1)
        acc += XY.T @ Z
    re = acc[:C, :kz] - acc[C:, kz:]
    im = acc[:C, kz:] + acc[C:, :kz]
    return torch.complex(re, im).reshape(kx, ky, kz)


def cube_accel_plain(x, tab, prm: CubeKernelParams, chunk: int = 65536):
    """Plain version of K8: (acc (N, 3), pot (N,)) f32 at x (N, 3) from the
    folded table (cube_force_table), factored as the kernel: the kz
    contractions t = tab . e_z and t_z = tab . (2 pi kz e_z), then
    e = e_kx e_ky, pot = Re sum t e, a_x, a_y = Im sum 2 pi k t e,
    a_z = Im sum t_z e."""
    AX, KY, KZ = prm.half_shape
    tb = torch.view_as_complex(tab).reshape(AX * KY, KZ)
    dev = x.device
    kxw = _TWO_PI * torch.arange(0, AX, dtype=torch.float32, device=dev)
    kyw = _TWO_PI * torch.arange(-prm.nmaxy, prm.nmaxy + 1,
                                 dtype=torch.float32, device=dev)
    kzw = _TWO_PI * torch.arange(-prm.nmaxz, prm.nmaxz + 1,
                                 dtype=torch.float32, device=dev)
    accs, pots = [], []
    for s in range(0, x.shape[0], chunk):
        u = wrap(x[s:s + chunk].to(torch.float32))
        ex = axis_phases(u[:, 0], prm.nmaxx, 1.0)[:, prm.nmaxx:]
        ey = axis_phases(u[:, 1], prm.nmaxy, 1.0)
        ez = axis_phases(u[:, 2], prm.nmaxz, 1.0)
        t = ez @ tb.T                                    # (B, AX * KY)
        tz = (ez * kzw) @ tb.T
        e = (ex[:, :, None] * ey[:, None, :]).reshape(-1, AX * KY)
        w = t * e
        wi = w.imag.reshape(-1, AX, KY)
        ax = (wi * kxw[None, :, None]).sum(dim=(1, 2))
        ay = (wi * kyw[None, None, :]).sum(dim=(1, 2))
        az = (tz * e).imag.sum(dim=1)
        accs.append(torch.stack([ax, ay, az], dim=1))
        pots.append(w.real.sum(dim=1))
    if not accs:
        return (torch.empty((0, 3), dtype=torch.float32, device=dev),
                torch.empty((0,), dtype=torch.float32, device=dev))
    return torch.cat(accs), torch.cat(pots)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def _on_card(x, name):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")


def cube_coef(x, mass, prm: CubeKernelParams):
    """K7 (and K11a): the raw sums S (Kx, Ky, Kz) complex64.

    x (N, 3), mass (N,), f32.  CPU tensors take cube_coef_plain; CUDA
    tensors launch csrc/cube_coef.cu."""
    check_params(prm)
    if x.device.type == "cpu":
        return cube_coef_plain(x, mass, prm)
    _on_card(x, "cube_coef")
    n = x.shape[0]
    dev = x.device
    _build.check_tensor(x, "x", (n, 3), dev)
    _build.check_tensor(mass, "mass", (n,), dev)
    fn, err = _build.bind("cube_coef", [_P, _P, _LL, _P, _I, _P, _I, _I, _I,
                                        _P])
    plan = coef_plan(
        n, prm, torch.cuda.get_device_properties(dev).multi_processor_count)
    partial = torch.empty((plan.nblocks, plan.pairs, prm.nmaxz + 1, 4),
                          dtype=torch.float32, device=dev)
    out = torch.empty((*prm.shape, 2), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(x.data_ptr(), mass.data_ptr(), n, partial.data_ptr(),
                  plan.nblocks, out.data_ptr(), prm.nmaxx, prm.nmaxy,
                  prm.nmaxz, stream)
    _build.raise_on(code, err, "cube_coef")
    launch_counts["cube_coef"] += 1
    return torch.view_as_complex(out)


def cube_accel(x, tab, prm: CubeKernelParams):
    """K8: cube force (acc (N, 3), pot (N,)) f32.

    x (N, 3), tab (nmaxx + 1, 2 nmaxy + 1, 2 nmaxz + 1, 2) from
    cube_force_table; f32.  CPU tensors take cube_accel_plain; CUDA tensors
    launch csrc/cube_accel.cu."""
    check_params(prm)
    if x.device.type == "cpu":
        return cube_accel_plain(x, tab, prm)
    _on_card(x, "cube_accel")
    n = x.shape[0]
    dev = x.device
    _build.check_tensor(x, "x", (n, 3), dev)
    _build.check_tensor(tab, "tab", (*prm.half_shape, 2), dev)
    fn, err = _build.bind("cube_accel", [_P, _LL, _P, _P, _P, _I, _I, _I, _I,
                                         _I, _P])
    props = torch.cuda.get_device_properties(dev)
    plan = accel_plan(n, prm, props.multi_processor_count,
                      props.shared_memory_per_block_optin)
    acc = torch.empty((n, 3), dtype=torch.float32, device=dev)
    pot = torch.empty((n,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(x.data_ptr(), n, tab.data_ptr(), acc.data_ptr(),
                  pot.data_ptr(), prm.nmaxx, prm.nmaxy, prm.nmaxz,
                  plan.nblocks, plan.warps, stream)
    _build.raise_on(code, err, "cube_accel")
    launch_counts["cube_accel"] += 1
    return acc, pot


def cube_accel_v1(x, R_re, R_im, prm: CubeKernelParams):
    """K11b: the force from the v1 packing (pack_force_matrix), through
    K8: b is read back from path 0 of (R_re, R_im), folded by
    cube_force_table, and handed to cube_accel."""
    b = v1_matrix_to_b(R_re, R_im, prm)
    return cube_accel(x, cube_force_table(b, prm), prm)
