"""snap2ascii — see exp_tpu_torch.cli.psptools.snap2ascii."""

import sys

from exp_tpu_torch.cli.psptools import snap2ascii as main

if __name__ == "__main__":
    sys.exit(main() or 0)
