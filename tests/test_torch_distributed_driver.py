"""The port's YAML driver on a world of two ranks against exp_tpu's
single-process driver (tests/test_distributed.py:256-320's analogue): the
shared launchers are in tests/torch_world.py."""

import os

import numpy as np
from torch_world import _distributed, _launch, one_cpu_thread  # noqa: F401


def test_two_rank_driver_matches_single_process(tmp_path):
    """tests/test_distributed.py:256-320 on the port: the YAML driver at
    multistep 2 through `python -m exp_tpu_torch.run --cpu --distributed`
    on 2 ranks (sharded ingest, big steps, relevels, OUTLOG, OutCoef,
    OutChkpt, OutMulti) against exp_tpu's single-process driver: OUTLOG
    to rtol 1e-9, the coefficients to 1e-10 of their scale, the same
    levels file, each file written once (rank 0 alone), and a restart of
    the world from its own checkpoint; `--ndev 2` prints the same
    OUTLOG."""
    from test_distributed import (DRIVER_CONFIG, _driver_workdir,
                                  _outlog_rows)

    from exp_tpu.io.coefs import open_coefs as j_open
    from exp_tpu.nbody.simulation import Simulation
    from exp_tpu_torch.io.coefs import open_coefs

    base = str(tmp_path)
    d2 = _driver_workdir(base, "world2", nsteps=6)
    d1 = _driver_workdir(base, "world1", nsteps=6)
    dn = _driver_workdir(base, "ndev2", nsteps=6)
    logs = _distributed(d2)
    assert sum("particle-steps/s" in log for log in logs) == 1
    _launch([(["--cpu", "--ndev", "2", "config.yml"], {})], dn)
    sim = Simulation.from_file(os.path.join(d1, "config.yml"))
    sim.prime()
    sim.run()

    log2 = _outlog_rows(os.path.join(d2, "OUTLOG.drun"))
    log1 = _outlog_rows(os.path.join(d1, "OUTLOG.drun"))
    assert log2.shape == log1.shape == (7, log1.shape[1])
    np.testing.assert_allclose(log2, log1, rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(
        _outlog_rows(os.path.join(dn, "OUTLOG.drun")), log2)
    t2, c2 = open_coefs(os.path.join(d2, "outcoef.halo.drun.h5")).read_all()
    t1, c1 = j_open(os.path.join(d1, "outcoef.halo.drun.h5")).read_all()
    assert len(t2) == len(t1) == 7
    np.testing.assert_allclose(t2, t1, atol=1e-12)
    np.testing.assert_allclose(c2, c1, atol=1e-10 * np.max(np.abs(c1)))
    lv = [[ln for ln in open(os.path.join(d, "drun.levels"))
           if not ln.startswith("#")] for d in (d2, d1)]
    assert lv[0] == lv[1] and len(lv[0]) == 7
    assert os.path.exists(os.path.join(d2, "config.drun.yml"))
    assert os.path.exists(os.path.join(d2, "OUT.drun.chkpt"))

    with open(os.path.join(d2, "config.yml"), "w") as f:
        f.write(DRIVER_CONFIG.format(nsteps=3,
                                     extra="  infile: OUT.drun.chkpt"))
    _distributed(d2)
    log2b = _outlog_rows(os.path.join(d2, "OUTLOG.drun"))
    assert log2b.shape[0] == 11, log2b.shape
    assert log2b[-1, 0] > log2[-1, 0] + 0.02
    E = log2b[:, 15]
    assert abs(E[-1] - E[0]) / abs(E[0]) < 5e-3

