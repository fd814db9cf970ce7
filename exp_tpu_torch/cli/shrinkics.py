"""shrinkics — see exp_tpu_torch.cli.psptools.shrinkics."""

import sys

from exp_tpu_torch.cli.psptools import shrinkics as main

if __name__ == "__main__":
    sys.exit(main() or 0)
