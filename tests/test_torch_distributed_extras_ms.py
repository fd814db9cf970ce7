"""The YAML driver's extras on a world of two ranks against the
port's one-rank run: the sphere at multistep 2.  The body of the test, its
cases and their configs are in tests/torch_world.py
(driver_extras_match_one_rank); the cases are split over
tests/test_torch_distributed_extras*.py so that the test workers
share them."""

import pytest
from torch_world import driver_extras_match_one_rank, one_cpu_thread  # noqa: F401


@pytest.mark.parametrize("case", ["sphere_ms"])
def test_two_rank_driver_extras_match_one_rank(tmp_path, case):
    driver_extras_match_one_rank(tmp_path, case)
