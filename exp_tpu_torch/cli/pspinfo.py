"""pspinfo — see exp_tpu_torch.cli.psptools.pspinfo."""

import sys

from exp_tpu_torch.cli.psptools import pspinfo as main

if __name__ == "__main__":
    sys.exit(main() or 0)
