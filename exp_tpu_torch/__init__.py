"""exp_tpu_torch: the PyTorch + CUDA (Hopper) port of exp_tpu.

A second package beside `exp_tpu`, written in PyTorch for an NVIDIA H100.
It imports neither `jax` nor anything of `exp_tpu`; where it needs host
code of that package it keeps its own copy.  The TPU's Pallas kernels
become CUDA C++ kernels under `csrc/`, built with nvcc at first use and
bound with ctypes (`ops/_build.py`); each has a plain PyTorch version of
the same math beside it, which the wrappers take only for CPU tensors.

Entry points run on the card unless the caller names another device:
`device=None` means CUDA, and raises when there is none.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` when given, else CUDA.

    Never falls back to the CPU on its own: with no device named and no
    CUDA device present this raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return torch.device("cuda")
