"""snapconvert — see exp_tpu_torch.cli.psptools.snapconvert."""

import sys

from exp_tpu_torch.cli.psptools import snapconvert as main

if __name__ == "__main__":
    sys.exit(main() or 0)
