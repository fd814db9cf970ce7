"""ascii2psp — see exp_tpu_torch.cli.psptools.ascii2psp."""

import sys

from exp_tpu_torch.cli.psptools import ascii2psp as main

if __name__ == "__main__":
    sys.exit(main() or 0)
