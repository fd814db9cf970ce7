"""hdf52accel — see exp_tpu_torch.cli.ics_tools.hdf52accel."""

import sys

from exp_tpu_torch.cli.ics_tools import hdf52accel as main

if __name__ == "__main__":
    sys.exit(main() or 0)
