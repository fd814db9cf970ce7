"""viewcoefs — see exp_tpu_torch.cli.analysis_tools.viewcoefs."""

import sys

from exp_tpu_torch.cli.analysis_tools import viewcoefs as main

if __name__ == "__main__":
    sys.exit(main() or 0)
