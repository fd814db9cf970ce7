"""Write K6's nonzero pattern, csrc/sphere_poly_support.cuh, from
ops/sphere_kernels.k6_support (the nonzeros of poly_matrix_stack at each
lmax K6 is built for).

    python -m exp_tpu_torch.gen_k6_support [--check]

The header is checked in: the kernel's build reads only sources in the
repository.  `--check` exits 1 when the file differs from what the
generator writes.
"""

from __future__ import annotations

import sys
from pathlib import Path

from exp_tpu_torch.ops import sphere_kernels as sk

HEADER = Path(__file__).resolve().parent / "csrc" / sk.K6_HEADER


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    text = sk.k6_header()
    if "--check" in argv:
        same = HEADER.exists() and HEADER.read_text() == text
        print(f"{HEADER.name}: {'up to date' if same else 'differs'}")
        return 0 if same else 1
    HEADER.write_text(text)
    print(f"wrote {HEADER}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
