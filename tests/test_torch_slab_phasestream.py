"""The slab phase-stream probe P1 (ops/slab_kernels.stream_coef and
phase_table, exp_tpu_torch/probe_slab_phasestream.py) against the JAX probe
(scripts/probe_slab_phasestream.py), loaded from its own file with
PROBE_NMAX / PROBE_NZC / PROBE_INTERP set first (it reads them at import):
the plain version against the JAX kernel in interpret mode on the same bf16
table, the two producers against each other, and both passes against the
f64 reference."""


import importlib.util
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache
from threadpoolctl import threadpool_limits

from exp_tpu_torch import probe_slab_phasestream as probe
from exp_tpu_torch.ops import slab_kernels as sk


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """numpy's and scipy's BLAS and torch at one thread while this module
    runs: several test workers share the CPUs, and a BLAS call at eight
    spinning threads a worker runs tens of times slower there than alone.
    The old limits come back at the end of the module.  JAX's persistent
    compilation cache, a directory every worker reads and writes without
    a lock, is off meanwhile (ROADMAP §3, F1)."""
    n, cache = torch.get_num_threads(), jax.config.jax_enable_compilation_cache
    torch.set_num_threads(1)
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)
    jax.config.update("jax_enable_compilation_cache", cache)
    compilation_cache.reset_cache()


ROOT = pathlib.Path(__file__).resolve().parent.parent
N = 4096          # a multiple of the JAX kernel's BLOCK (1024)
# The plain version and the JAX kernel multiply the same bf16 table by the
# same f32 z weights; they differ by the order of their f32 sums (and the
# JAX stream2 adds two products where the port adds hi + lo first):
# max|dG|/max|G| gated at 1e-6.
SUM_TOL = 1e-6
# Against the f64 reference, relative to max|G|.  |G_k(j)| <= G_0(j) =
# sum w Wz[j] (the k = 0 row, whose phases are exactly 1), and a bf16 phase
# is within 2^-9 of its value relatively, so stream1 errs by at most 2^-9
# of max|G|; hi + lo carries a phase to 2^-17, so stream2 to 2^-16 with the
# f32 sums.
REF_TOL = {False: 2.0 ** -9, True: 2.0 ** -16}


def _load_jax_probe(interp, nmax=4, nzc=126):
    keys = {"PROBE_NMAX": str(nmax), "PROBE_NZC": str(nzc),
            "PROBE_INTERP": interp, "PROBE_N": str(N)}
    old = {k: os.environ.get(k) for k in keys}
    os.environ.update(keys)
    try:
        spec = importlib.util.spec_from_file_location(
            f"_jax_probe_slab_phasestream_{interp}",
            ROOT / "scripts" / "probe_slab_phasestream.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return mod


def _inputs():
    """The probe's particles, the last rows replaced by edge rows: zero
    mass, |z| > zmax, z exactly +-zmax (f32)."""
    x, m = probe.probe_sample(N)
    zmax = np.float32(probe.ZMAX)
    x[-5:, 2] = [0.01, 0.3, -0.25, zmax, -zmax]
    m[-5] = 0.0
    return x, m


@pytest.fixture(scope="module", params=["spline", "linear"])
def case(request):
    jp = _load_jax_probe(request.param)
    prm = probe.probe_params(4, 126, request.param)
    assert (jp.C, jp.CR, jp.ZROWS) == (prm.C, sk.phase_rows(prm), prm.zrows)
    x, m = _inputs()
    xyzm8 = jp.pack_xyzm(jnp.asarray(x), jnp.asarray(m))
    return jp, prm, x, m, xyzm8


def _bf16_to_torch(a):
    return torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(
        torch.bfloat16)


@pytest.mark.parametrize("split", [False, True], ids=["stream1", "stream2"])
def test_plain_matches_jax_kernel(case, split):
    """P1's plain version against the JAX kernel in interpret mode, both
    fed the JAX producer's bf16 table."""
    jp, prm, x, m, xyzm8 = case
    ph = jp.make_phase_producer(split)(xyzm8)
    gj = np.asarray(jp.make_stream_kernel(split, interpret=True)(ph, xyzm8))
    gp = sk.stream_coef(_bf16_to_torch(ph), torch.tensor(x), torch.tensor(m),
                        prm).numpy()
    err = np.abs(gp - gj).max() / np.abs(gj).max()
    print(f"P1 {prm.interp} split={split}: plain vs JAX kernel {err:.3e}")
    assert err <= SUM_TOL, err


@pytest.mark.parametrize("split", [False, True], ids=["stream1", "stream2"])
def test_producers_agree(case, split):
    """The port's producer against the JAX one.  The f32 phases of the two
    differ by an ulp where cos/sin round differently (~5% of them), which
    flips a bf16 rounding rarely: the hi rows differ in under 1e-3 of their
    entries, each by one bf16 ulp.  A lo row is the bf16 rounding of the
    residual, whose ulp can be far below the phase's f32 ulp, so lo entries
    differ more often and by more; what the kernel uses, hi + lo, carries
    each phase to 2^-17, so the two reconstructions agree within 2^-16."""
    jp, prm, x, _, xyzm8 = case
    ha = np.asarray(jp.make_phase_producer(split)(xyzm8))
    hb = sk.phase_table(torch.tensor(x), prm, split)
    a, b = ha.view(np.int16), hb.view(torch.int16).numpy()
    assert a.shape == b.shape
    hi = slice(0, 2 * sk.phase_rows(prm))
    diff = a[hi] != b[hi]
    print(f"producers {prm.interp} split={split}: {diff.sum()} of "
          f"{diff.size} hi entries differ ({diff.mean():.2e})")
    assert diff.mean() < 1e-3
    da, db = a[hi][diff].astype(np.int32), b[hi][diff].astype(np.int32)
    assert np.all((np.abs(da - db) == 1) & ((da < 0) == (db < 0))), (da, db)
    if split:
        fa, fb = ha.astype(np.float32), hb.to(torch.float32).numpy()
        ra, rb = fa[hi] + fa[hi.stop:], fb[hi] + fb[hi.stop:]
        assert np.abs(ra - rb).max() <= 2.0 ** -16


@pytest.mark.parametrize("split", [False, True], ids=["stream1", "stream2"])
def test_against_f64_reference(case, split):
    """Both passes (the JAX kernel on its table, the port's plain version on
    its own) against the f64 reference, within what bf16 phases allow."""
    jp, prm = case[:2]
    # the bulk alone: the f64 reference masks z = +-f32(zmax), which lies
    # beyond the f64 zmax, where the f32 passes count it
    x, m = probe.probe_sample(N)
    xyzm8 = jp.pack_xyzm(jnp.asarray(x), jnp.asarray(m))
    ref = probe.ref_numpy(x, m, prm)
    np.testing.assert_allclose(ref, jp.ref_numpy(np.asarray(xyzm8), N),
                               rtol=1e-12, atol=1e-16)
    scale = np.abs(ref).max()
    gj = np.asarray(jp.make_stream_kernel(split, interpret=True)(
        jp.make_phase_producer(split)(xyzm8), xyzm8))
    gp = probe.stream_pass(torch.tensor(x), torch.tensor(m), prm,
                           split).numpy()
    ej = np.abs(gj - ref).max() / scale
    ep = np.abs(gp - ref).max() / scale
    print(f"P1 {prm.interp} split={split}: JAX {ej:.3e}, port {ep:.3e} "
          f"(bound {REF_TOL[split]:.2e})")
    assert ej <= REF_TOL[split] and ep <= REF_TOL[split]


def test_edge_rows_add_nothing(case):
    """Zero-mass rows and rows beyond |z| = zmax add exactly 0; rows at
    z = +-zmax count."""
    _, prm, x, m, _ = case
    for split in (False, True):
        xt, mt = torch.tensor(x[-4:-2]), torch.tensor(m[-4:-2])
        g = probe.stream_pass(xt, mt, prm, split)
        assert float(g.abs().max()) == 0.0
        xt, mt = torch.tensor(x[-5:-4]), torch.tensor(np.zeros(1, np.float32))
        assert float(probe.stream_pass(xt, mt, prm, split).abs().max()) == 0.0
        xt, mt = torch.tensor(x[-2:]), torch.tensor(m[-2:])
        assert float(probe.stream_pass(xt, mt, prm, split).abs().max()) > 0.0


def test_probe_check_and_refusals():
    """The probe's CPU check runs; stream1 errs above stream2, which errs as
    K9; the table and the geometry are checked."""
    rows = {r["variant"]: r["max_err"] for r in probe.check(n=2048,
                                                             device="cpu")}
    assert rows["stream2_bf16x2"] < 1e-5 < rows["stream1_bf16"] < 2.0 ** -9
    assert rows["v3_lattice"] < 1e-5
    prm = probe.probe_params()
    x = torch.zeros((8, 3))
    with pytest.raises(ValueError, match="phase table"):
        sk.stream_coef(torch.zeros((5, 8), dtype=torch.bfloat16), x,
                       torch.zeros(8), prm)
    props = type("P", (), {"shared_memory_per_block_optin": 232448,
                           "shared_memory_per_multiprocessor": 233472,
                           "multi_processor_count": 132})
    for split, tile in ((False, 128), (True, 64)):
        p = sk.stream_plan(prm, split, props, 2 ** 20)
        assert (p.tile, p.threads, p.nblocks) == (tile, 192, 264)
    assert sk.stream_plan(prm, True, props, 1).nblocks == 1
    with pytest.raises(ValueError, match="threads"):
        sk.stream_plan(probe.probe_params(nmax=6), False, props, 100)
    with pytest.raises(RuntimeError, match="times the card"):
        probe.bench(n=8, device="cpu")
