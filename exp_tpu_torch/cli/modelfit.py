"""modelfit — see exp_tpu_torch.cli.ics_tools.modelfit."""

import sys

from exp_tpu_torch.cli.ics_tools import modelfit as main

if __name__ == "__main__":
    sys.exit(main() or 0)
