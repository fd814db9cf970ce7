"""h5compare — see exp_tpu_torch.cli.analysis_tools.h5compare."""

import sys

from exp_tpu_torch.cli.analysis_tools import h5compare as main

if __name__ == "__main__":
    sys.exit(main() or 0)
