"""The port's run configuration (exp_tpu_torch/config.py) against exp_tpu's:
the same keys, defaults, coercions and refusals, and the same parsed
config from the same YAML (tests/test_simulation.py:58 and :862's flows)."""

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache
from threadpoolctl import threadpool_limits

import exp_tpu.config as jcfg
import exp_tpu_torch.config as tcfg


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

CONFIG = """\
Global:
  dtime: 0.02
  nsteps: 20
  runtag: trun
  multistep: 2
  dynfracA: 0.05
  nbodmax: "100000"
  maxMindt: 1.0e30
  fpe_trap: true
  nthrds: 4
Components:
  - name: halo
    bodyfile: halo.bods
    parameters: {rtrunc: 2.0, com: true}
    force:
      id: sphereSL
      parameters: {numr: 800, Lmax: 2, nmax: 8, modelname: halo.model}
  - name: disk
    bodyfile: disk.bods
    force:
      id: cylinder
      parameters: {mmax: 2, nmax: 4}
Interaction:
  - halo: disk
  - disk: halo
Output:
  - id: outlog
    parameters: {nint: 1}
  - id: outpsn
    parameters: {nint: 10}
"""


def _asdict(cfg):
    return {"glob": dataclasses.asdict(cfg.glob),
            "components": [dataclasses.asdict(c) for c in cfg.components],
            "outputs": [dataclasses.asdict(o) for o in cfg.outputs],
            "external": cfg.external, "interactions": cfg.interactions}


@pytest.mark.parametrize("name", [
    "_GLOBAL_KEYS", "_IGNORED_GLOBAL_KEYS", "_COMPONENT_KEYS", "_FORCE_KEYS",
    "_OUTPUT_KEYS", "KNOWN_FORCES", "KNOWN_OUTPUTS"])
def test_allowed_key_sets_equal(name):
    assert getattr(tcfg, name) == getattr(jcfg, name)


def test_global_fields_and_defaults_equal():
    jf = {f.name: (f.type, f.default)
          for f in dataclasses.fields(jcfg.GlobalConfig)}
    tf = {f.name: (f.type, f.default)
          for f in dataclasses.fields(tcfg.GlobalConfig)}
    assert tf == jf


def test_same_yaml_parses_the_same(tmp_path):
    p = tmp_path / "config.yml"
    p.write_text(CONFIG)
    j = jcfg.RunConfig.from_file(p)
    t = tcfg.RunConfig.from_file(p)
    assert _asdict(t) == _asdict(j)
    # coercions: quoted ints, exponents; fpe_trap -> fpe=True
    assert t.glob.nbodmax == 100000 and t.glob.maxMindt == 1.0e30
    assert t.glob.fpe is True
    assert t.interactions == [("halo", "disk"), ("disk", "halo")]


@pytest.mark.parametrize("edit", [
    ("dtime", "dtmie"),                     # Global
    ("bodyfile: disk.bods", "bodyfile: disk.bods\n    colour: red"),
    ("      id: cylinder", "      id: cylinder\n      extra: 1"),
    ("      id: cylinder", "      id: nosuchforce"),
    ("  - id: outpsn", "  - id: outnothing"),
    ("    parameters: {nint: 10}", "    parameters: {nint: 10}\n    x: 1"),
    ("Interaction:", "Interactions:"),
    ("  nsteps: 20", "  nsteps: twenty"),
], ids=["global", "component", "force", "force_id", "output_id", "output",
        "top", "coercion"])
def test_unknown_keys_and_bad_values_raise_in_both(tmp_path, edit):
    p = tmp_path / "bad.yml"
    p.write_text(CONFIG.replace(*edit))
    with pytest.raises(jcfg.ConfigError):
        jcfg.RunConfig.from_file(p)
    with pytest.raises(tcfg.ConfigError):
        tcfg.RunConfig.from_file(p)


@pytest.mark.parametrize("raw", [None, {"Global": {"dtime": 0.1}}],
                         ids=["empty", "no_components"])
def test_empty_configs_raise_in_both(raw):
    with pytest.raises(jcfg.ConfigError):
        jcfg.RunConfig.from_dict(raw)
    with pytest.raises(tcfg.ConfigError):
        tcfg.RunConfig.from_dict(raw)


def test_fpe_flags_map_as_exp_tpu():
    comps = [{"name": "h", "bodyfile": "b", "force": {"id": "noforce"}}]
    for g, want in (({"fpe_trap": True}, True), ({"fpe_trace": True},
                                                 "trace"), ({}, False)):
        raw = {"Global": g, "Components": comps}
        assert tcfg.RunConfig.from_dict(raw).glob.fpe == want
        assert jcfg.RunConfig.from_dict(raw).glob.fpe == want


def test_dump_reads_back_in_both(tmp_path):
    p = tmp_path / "config.yml"
    p.write_text(CONFIG)
    t = tcfg.RunConfig.from_file(p)
    t.dump(tmp_path / "echo.yml")
    j2 = jcfg.RunConfig.from_file(tmp_path / "echo.yml")
    t2 = tcfg.RunConfig.from_file(tmp_path / "echo.yml")
    assert _asdict(t2) == _asdict(t) == _asdict(j2)


def test_from_dict_needs_no_yaml():
    """RunConfig.from_dict runs where PyYAML is missing (yaml blocked)."""
    code = ("import sys; sys.modules['yaml'] = None\n"
            "from exp_tpu_torch.config import RunConfig\n"
            "c = RunConfig.from_dict({'Global': {'nsteps': 3}, 'Components':"
            " [{'name': 'h', 'bodyfile': 'b', 'force': {'id': 'noforce'}}]})\n"
            "print(c.glob.nsteps, c.components[0].force.id)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["3", "noforce"]
