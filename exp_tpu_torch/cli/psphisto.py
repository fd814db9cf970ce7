"""psphisto — see exp_tpu_torch.cli.psptools.psphisto."""

import sys

from exp_tpu_torch.cli.psptools import psphisto as main

if __name__ == "__main__":
    sys.exit(main() or 0)
