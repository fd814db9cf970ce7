"""diskprof — see exp_tpu_torch.cli.analysis_tools.diskprof."""

import sys

from exp_tpu_torch.cli.analysis_tools import diskprof as main

if __name__ == "__main__":
    sys.exit(main() or 0)
