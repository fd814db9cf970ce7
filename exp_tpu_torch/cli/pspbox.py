"""pspbox — see exp_tpu_torch.cli.psptools.pspbox."""

import sys

from exp_tpu_torch.cli.psptools import pspbox as main

if __name__ == "__main__":
    sys.exit(main() or 0)
