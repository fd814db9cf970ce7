"""pspinterp — see exp_tpu_torch.cli.psptools.pspinterp."""

import sys

from exp_tpu_torch.cli.psptools import pspinterp as main

if __name__ == "__main__":
    sys.exit(main() or 0)
