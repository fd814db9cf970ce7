"""orthochk — see exp_tpu_torch.cli.analysis_tools.orthochk."""

import sys

from exp_tpu_torch.cli.analysis_tools import orthochk as main

if __name__ == "__main__":
    sys.exit(main() or 0)
