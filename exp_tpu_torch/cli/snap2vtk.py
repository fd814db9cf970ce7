"""snap2vtk — see exp_tpu_torch.cli.psptools.snap2vtk."""

import sys

from exp_tpu_torch.cli.psptools import snap2vtk as main

if __name__ == "__main__":
    sys.exit(main() or 0)
