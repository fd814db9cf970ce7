"""pspstat — see exp_tpu_torch.cli.psptools.pspstat."""

import sys

from exp_tpu_torch.cli.psptools import pspstat as main

if __name__ == "__main__":
    sys.exit(main() or 0)
