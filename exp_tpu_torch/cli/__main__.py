"""Umbrella dispatcher: python -m exp_tpu_torch.cli <tool> [args...]"""

import importlib
import sys

from exp_tpu_torch.cli import TOOLS


def main():
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help"):
        print("usage: python -m exp_tpu_torch.cli <tool> [args...]")
        print("tools:", ", ".join(TOOLS))
        return 0
    tool = sys.argv[1]
    if tool not in TOOLS:
        print(f"unknown tool {tool!r}; available: {', '.join(TOOLS)}")
        return 2
    mod = importlib.import_module(f"exp_tpu_torch.cli.{tool}")
    return mod.main(sys.argv[2:]) or 0


if __name__ == "__main__":
    sys.exit(main())
