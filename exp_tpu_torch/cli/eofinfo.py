"""eofinfo — see exp_tpu_torch.cli.analysis_tools.eofinfo."""

import sys

from exp_tpu_torch.cli.analysis_tools import eofinfo as main

if __name__ == "__main__":
    sys.exit(main() or 0)
