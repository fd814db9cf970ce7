"""Native (C++) IO kernels, compiled on demand and loaded through ctypes
(port of exp_tpu/native/__init__.py).

The runtime counterpart of the reference's C++ reader layer (exputil/
ParticleReader.cc, Component body readers): a host parser of ascii body
tables, not a device kernel.  `fastio.cpp` is built by g++ at first use
into the port's build directory, `exp_tpu_torch/_build/` (listed in
.gitignore), under a name that carries a hash of the source and the
flags.  Each process compiles to a temporary file of its own and renames
it into place, so processes that build at once (ranks of one world, test
workers) never see half a library.  With no compiler, or with
EXP_TPU_NO_NATIVE set, `get_lib()` returns None and the callers read with
NumPy (`read_columns`), as exp_tpu's do; the values are the same bit for
bit.  Unlike NumPy's fixed-width parser the native one reads rows with
trailing attribute columns of any length.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from exp_tpu_torch.ops._build import BUILD_DIR

SRC = Path(__file__).resolve().parent / "fastio.cpp"
GXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_LIB = None
_TRIED = False


def lib_path() -> Path:
    """The library's file: its name carries a hash of source and flags."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return Path(BUILD_DIR) / f"libfastio-{h.hexdigest()[:12]}.so"


def _build_lib():
    sofile = lib_path()
    if not sofile.exists():
        sofile.parent.mkdir(parents=True, exist_ok=True)
        tmp = sofile.with_suffix(f".{os.getpid()}.tmp")
        try:
            subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                           check=True, capture_output=True)
            os.replace(tmp, sofile)    # atomic: never half a library
        finally:
            tmp.unlink(missing_ok=True)
    lib = ctypes.CDLL(str(sofile))
    lib.parse_table.restype = ctypes.c_long
    lib.parse_table.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                ctypes.POINTER(ctypes.c_double),
                                ctypes.c_long, ctypes.c_int]
    lib.count_columns.restype = ctypes.c_int
    lib.count_columns.argtypes = [ctypes.c_char_p, ctypes.c_long]
    return lib


def get_lib():
    """The compiled library, or None if unavailable (no compiler, or
    EXP_TPU_NO_NATIVE set)."""
    global _LIB, _TRIED
    if os.environ.get("EXP_TPU_NO_NATIVE"):
        return None
    if not _TRIED:
        _TRIED = True
        try:
            _LIB = _build_lib()
        except Exception:
            _LIB = None
    return _LIB


def parse_table(data: bytes, start: int, max_rows: int,
                ncols: int) -> np.ndarray:
    """Parse a whitespace-separated numeric table from bytes.

    Returns (rows, ncols) float64.  Raises RuntimeError if the native lib
    is unavailable (callers fall back to numpy)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native fastio unavailable")
    out = np.empty((max_rows, ncols), dtype=np.float64)
    n = lib.parse_table(
        data, start,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        max_rows, ncols)
    return out[:n]


def read_ascii_table(path, max_rows=None, ncols=None, skip_lines=0):
    """Fast ascii table reader with automatic column detection."""
    with open(path, "rb") as f:
        data = f.read() + b"\x00"
    start = 0
    for _ in range(skip_lines):
        nl = data.find(b"\n", start)
        if nl < 0:
            break
        start = nl + 1
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native fastio unavailable")
    if ncols is None:
        ncols = lib.count_columns(data, start)
        if ncols <= 0:
            raise ValueError(f"no numeric columns found in {path}")
    if max_rows is None:
        max_rows = data.count(b"\n", start) + 1
    return parse_table(data, start, max_rows, ncols)


def read_columns(path, cols, max_rows, skip_lines=0) -> np.ndarray:
    """Columns `cols` of up to `max_rows` rows after `skip_lines` lines of
    an ascii table, (rows, len(cols)) float64: through the native parser
    when it is built, else np.loadtxt (the same values)."""
    cols = list(cols)
    if get_lib() is not None:
        ncols = max(cols) + 1
        data = read_ascii_table(path, max_rows=max_rows, ncols=ncols,
                                skip_lines=skip_lines)
        return data if cols == list(range(ncols)) else data[:, cols]
    with open(path) as f:
        for _ in range(skip_lines):
            f.readline()
        return np.loadtxt(f, max_rows=max_rows, usecols=cols, ndmin=2)
