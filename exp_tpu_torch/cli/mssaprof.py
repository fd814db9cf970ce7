"""mssaprof — see exp_tpu_torch.cli.analysis_tools.mssaprof."""

import sys

from exp_tpu_torch.cli.analysis_tools import mssaprof as main

if __name__ == "__main__":
    sys.exit(main() or 0)
