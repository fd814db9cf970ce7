"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each `csrc/<name>.cu` is compiled on its own by nvcc for sm_90a into a
shared library with a plain C interface, at first use, into
`exp_tpu_torch/_build/` (listed in .gitignore).  The file name carries a
hash of the sources, headers and flags, so an edited source is rebuilt and
an unchanged one is loaded as it stands.  `build_all` starts one nvcc for
each source at once (`start_all` and `finish_all` are its two halves).  A failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("sphere_coef", "sphere_accel", "sphere_coef_rec",
           "sphere_accel_poly", "cyl_coef", "cyl_accel", "cube_coef",
           "cube_accel", "slab_coef", "slab_accel", "slab_phasestream")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source; returns (process, tmp, target, log) or
    None when the library is already built."""
    target = _lib_path(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    log = target.with_suffix(".log")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target, log, time.perf_counter()


def _finish(name: str, job) -> None:
    proc, tmp, target, log, t0 = job
    out, _ = proc.communicate()
    out += f"nvcc {name}.cu: {time.perf_counter() - t0:.1f} s\n"
    log.write_text(out)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, target)        # atomic: a reader never sees half a file


def start_all(names=SOURCES) -> dict:
    """Start nvcc for every named source whose library is not built, all
    at once; finish_all waits for them.  The caller may do other work in
    between."""
    return {n: _start(n) for n in names}


def finish_all(jobs) -> dict[str, str]:
    """Wait for the builds of start_all; returns {name: nvcc's output} for
    the sources they built.  A failed build raises, and the builds still
    running are stopped."""
    logs = {}
    try:
        for n, job in jobs.items():
            if job is not None:
                _finish(n, job)
                logs[n] = job[3].read_text()
    finally:
        for job in jobs.values():
            if job is not None and job[0].poll() is None:
                job[0].kill()
                job[0].wait()
    return logs


def build_all(names=SOURCES) -> dict[str, str]:
    """Build every named kernel library, all nvcc processes at once.
    Returns {name: nvcc's output} for the sources built by this call."""
    return finish_all(start_all(names))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        _loaded[name] = lib
    return lib


def bind(name: str, argtypes):
    """(`<name>_launch`, `<name>_error_string`) of csrc/<name>.cu, typed:
    the launcher returns a cudaError_t as an int."""
    lib = load(name)
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def raise_on(code: int, err, name: str) -> None:
    """Raise when a launcher returned a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name} kernel failed: CUDA error {code} "
                           f"({err(code).decode()})")


def check_tensor(t, name, shape, device) -> None:
    """A kernel argument must be a contiguous f32 tensor of `shape` on
    `device`."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def div_f32(a, c):
    """a / c for a Python float c, rounded as IEEE division of f32 values,
    as the kernels divide.  (PyTorch on CUDA multiplies by the reciprocal
    of a Python scalar divisor instead, an ulp away: enough to move a grid
    position across a node, and a force that changes fast there with it.)"""
    return a / a.new_tensor(c)
