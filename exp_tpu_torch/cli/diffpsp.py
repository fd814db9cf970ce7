"""diffpsp — see exp_tpu_torch.cli.psptools.diffpsp."""

import sys

from exp_tpu_torch.cli.psptools import diffpsp as main

if __name__ == "__main__":
    sys.exit(main() or 0)
