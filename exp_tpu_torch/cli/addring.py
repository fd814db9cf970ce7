"""addring — see exp_tpu_torch.cli.ics_tools.addring."""

import sys

from exp_tpu_torch.cli.ics_tools import addring as main

if __name__ == "__main__":
    sys.exit(main() or 0)
