"""psp2hdf5 — see exp_tpu_torch.cli.psptools.psp2hdf5."""

import sys

from exp_tpu_torch.cli.psptools import psp2hdf5 as main

if __name__ == "__main__":
    sys.exit(main() or 0)
