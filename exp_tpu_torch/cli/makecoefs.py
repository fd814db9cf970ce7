"""makecoefs — see exp_tpu_torch.cli.analysis_tools.makecoefs."""

import sys

from exp_tpu_torch.cli.analysis_tools import makecoefs as main

if __name__ == "__main__":
    sys.exit(main() or 0)
