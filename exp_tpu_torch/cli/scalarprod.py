"""scalarprod — see exp_tpu_torch.cli.analysis_tools.scalarprod."""

import sys

from exp_tpu_torch.cli.analysis_tools import scalarprod as main

if __name__ == "__main__":
    sys.exit(main() or 0)
