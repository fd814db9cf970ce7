"""h5power — see exp_tpu_torch.cli.analysis_tools.h5power."""

import sys

from exp_tpu_torch.cli.analysis_tools import h5power as main

if __name__ == "__main__":
    sys.exit(main() or 0)
