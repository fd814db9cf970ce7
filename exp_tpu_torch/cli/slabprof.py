"""slabprof — see exp_tpu_torch.cli.analysis_tools.slabprof."""

import sys

from exp_tpu_torch.cli.analysis_tools import slabprof as main

if __name__ == "__main__":
    sys.exit(main() or 0)
