"""coefstoh5 — see exp_tpu_torch.cli.analysis_tools.coefstoh5."""

import sys

from exp_tpu_torch.cli.analysis_tools import coefstoh5 as main

if __name__ == "__main__":
    sys.exit(main() or 0)
