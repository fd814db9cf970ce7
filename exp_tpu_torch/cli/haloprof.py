"""haloprof — see exp_tpu_torch.cli.analysis_tools.haloprof."""

import sys

from exp_tpu_torch.cli.analysis_tools import haloprof as main

if __name__ == "__main__":
    sys.exit(main() or 0)
