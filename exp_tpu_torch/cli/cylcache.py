"""cylcache — see exp_tpu_torch.cli.analysis_tools.cylcache."""

import sys

from exp_tpu_torch.cli.analysis_tools import cylcache as main

if __name__ == "__main__":
    sys.exit(main() or 0)
