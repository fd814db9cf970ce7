"""addsphmod — see exp_tpu_torch.cli.ics_tools.addsphmod."""

import sys

from exp_tpu_torch.cli.ics_tools import addsphmod as main

if __name__ == "__main__":
    sys.exit(main() or 0)
