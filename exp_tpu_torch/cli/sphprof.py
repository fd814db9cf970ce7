"""sphprof — see exp_tpu_torch.cli.analysis_tools.sphprof."""

import sys

from exp_tpu_torch.cli.analysis_tools import sphprof as main

if __name__ == "__main__":
    sys.exit(main() or 0)
