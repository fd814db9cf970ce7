"""slcheck — see exp_tpu_torch.cli.analysis_tools.slcheck."""

import sys

from exp_tpu_torch.cli.analysis_tools import slcheck as main

if __name__ == "__main__":
    sys.exit(main() or 0)
