"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports nothing of jax or exp_tpu, so it also runs where only the port's
dependencies are installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Every test skips without a CUDA device.
"""

import numpy as np
import pytest
import torch

from exp_tpu_torch.basis.model import hernquist_model
from exp_tpu_torch.basis.slgrid import build_sph_sl_tables
from exp_tpu_torch.bench_sphere import hernquist_sample_np
from exp_tpu_torch.forces.spherical import SphereSL
from exp_tpu_torch.ops import sphere_kernels as sk

N = 20_000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _inputs(device):
    x, _, m = hernquist_sample_np(N, seed=1)
    x = np.concatenate([x, [[0.0, 0.0, 0.0], [0.0, 0.0, 0.7],
                            [0.0, 0.0, -1.3], [30.0, 0.0, 0.0],
                            [3e-4, 0.0, 1e-4], [0.3, 0.2, 0.1]]])
    m = np.concatenate([m, [1e-4] * 5 + [0.0]])
    return (torch.tensor(x, dtype=torch.float32, device=device),
            torch.tensor(m, dtype=torch.float32, device=device))


@pytest.mark.gpu
@pytest.mark.parametrize("lmax", [0, 2, 4, 6])
def test_kernels_match_plain_versions(cuda, lmax):
    """K1: max|dc|/max|c| < 1e-5 (f32 sums in another order); K2: acc
    rtol 1e-4 / atol 1e-6, pot rtol 1e-5 / atol 1e-7 (FMA contraction);
    each wrapper call on the card counts one launch."""
    t = build_sph_sl_tables(hernquist_model(rmin=1e-3, rmax=20.0), lmax=lmax,
                            nmax=6, numr=800, cmap=1, rmap=1.0)
    f = SphereSL.from_tables(t, backend="pallas", device=cuda)
    prm = f._kernel_params()
    x, m = _inputs(cuda)
    before = dict(sk.launch_counts)
    c = sk.sphere_coef(x, m, f.tabc_s, f.Mp, prm)
    c0 = sk.sphere_coef_plain(x, m, f.tabc_s, f.Mp, prm)
    torch.cuda.synchronize()
    assert float((c - c0).abs().max() / c0.abs().max()) < 1e-5
    twT = sk.contract_coef_table2(c0, f.tabc_s, f.tabd_s, f.prows)
    a, p = sk.sphere_accel(x, twT, f.fac32, prm)
    a0, p0 = sk.sphere_accel_plain(x, twT, f.fac32, prm)
    torch.cuda.synchronize()
    torch.testing.assert_close(a, a0, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(p, p0, rtol=1e-5, atol=1e-7)
    assert sk.launch_counts["sphere_coef"] == before["sphere_coef"] + 1
    assert sk.launch_counts["sphere_accel"] == before["sphere_accel"] + 1


@pytest.mark.gpu
def test_wrappers_reject_bad_inputs(cuda):
    t = build_sph_sl_tables(hernquist_model(rmin=1e-3, rmax=20.0), lmax=2,
                            nmax=4, numr=400, cmap=1, rmap=1.0)
    f = SphereSL.from_tables(t, backend="pallas", device=cuda)
    prm = f._kernel_params()
    x, m = _inputs(cuda)
    with pytest.raises(TypeError, match="float32"):
        sk.sphere_coef(x.double(), m, f.tabc_s, f.Mp, prm)
    with pytest.raises(ValueError, match="contiguous"):
        sk.sphere_coef(x.t().contiguous().t(), m, f.tabc_s, f.Mp, prm)
    with pytest.raises(ValueError, match="shape"):
        sk.sphere_coef(x, m[:-1], f.tabc_s, f.Mp, prm)
    with pytest.raises(ValueError, match="is on"):
        sk.sphere_accel(x, f.tabc_s.cpu(), f.fac32, prm)


@pytest.mark.gpu
def test_step_on_card_matches_cpu(cuda):
    """One KDK step through the kernels against the same step through the
    plain versions on the CPU: positions and velocities to f32 roundoff."""
    from exp_tpu_torch.nbody.particles import ParticleSystem
    from exp_tpu_torch.nbody.step import init_force_state, make_kdk_step

    t = build_sph_sl_tables(hernquist_model(rmin=1e-3, rmax=20.0), lmax=4,
                            nmax=10, numr=2000, cmap=1, rmap=1.0)
    x, v, m = hernquist_sample_np(N, seed=2)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        f = SphereSL.from_tables(t, backend="pallas", device=dev)
        ps = ParticleSystem.from_arrays(x, v, m, device=dev)
        ps, _, _ = init_force_state(f, ps)
        ps, _, _ = make_kdk_step(f, 1e-3)(ps)
        out[dev.type] = (ps.x.cpu(), ps.v.cpu())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-4,
                               atol=1e-6)
