"""psp2ascii — see exp_tpu_torch.cli.psptools.psp2ascii."""

import sys

from exp_tpu_torch.cli.psptools import psp2ascii as main

if __name__ == "__main__":
    sys.exit(main() or 0)
