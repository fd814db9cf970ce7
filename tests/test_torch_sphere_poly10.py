"""K1 and K6 at lmax 10 with the 'poly' harmonics against exp_tpu: the
cases of tests/test_torch_sphere_poly.py at lmax 10 (its module docstring
says what they hold), and the lmax-10 tables carried across."""

import dataclasses

import numpy as np
import pytest
from test_torch_sphere_poly import (_one_cpu_thread, _tables,  # noqa: F401
                                    sample)
from test_torch_sphere_poly import \
    test_poly_plain_matches_jax_pallas_above_lmax6 as _case

from exp_tpu_torch.forces.spherical import SphereSL


@pytest.mark.parametrize("L,interp", [(10, "spline"), (10, "hat")])
def test_poly_plain_matches_jax_pallas_above_lmax6(sample, L, interp):
    _case(sample, L, interp)


def test_lmax10_tables_carry_across():
    """sph_tables_from_numpy carries exp_tpu's lmax-10 tables to the port
    bit for bit, and the port's pallas SphereSL builds its poly matrices
    from them: M (121, 286) and the stack (484, 286)."""
    t, tp = _tables(10)
    for k, v in dataclasses.asdict(t).items():
        a, b = np.asarray(v), np.asarray(getattr(tp, k))
        assert a.shape == b.shape and np.array_equal(a, b), k
    fp = SphereSL.from_tables(tp, backend="pallas", device="cpu",
                              pallas_harmonics="poly")
    assert fp.lmax == 10 and fp.Mp.shape == (121, 286)
    assert fp.Ms.shape == (484, 286)
