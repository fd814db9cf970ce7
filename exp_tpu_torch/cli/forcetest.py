"""forcetest — see exp_tpu_torch.cli.ics_tools.forcetest."""

import sys

from exp_tpu_torch.cli.ics_tools import forcetest as main

if __name__ == "__main__":
    sys.exit(main() or 0)
