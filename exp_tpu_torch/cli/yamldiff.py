"""yamldiff — structural diff of two YAML config files
(utils/Analysis/yaml_diff.cc): prints added/removed/changed keys by path;
exit 0 if identical.  Port of exp_tpu/cli/yamldiff.py."""

import sys

from exp_tpu_torch.cli._common import make_parser


def _flatten(node, prefix=""):
    out = {}
    if isinstance(node, dict):
        for k, v in node.items():
            out.update(_flatten(v, f"{prefix}{k}."))
    elif isinstance(node, list):
        for i, v in enumerate(node):
            out.update(_flatten(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = node
    return out


def main(argv=None):
    ap = make_parser("yamldiff", __doc__)
    ap.add_argument("file1")
    ap.add_argument("file2")
    a = ap.parse_args(argv)
    import yaml

    with open(a.file1) as f:
        d1 = _flatten(yaml.safe_load(f) or {})
    with open(a.file2) as f:
        d2 = _flatten(yaml.safe_load(f) or {})
    diff = 0
    for k in sorted(set(d1) - set(d2)):
        print(f"- {k}: {d1[k]}")
        diff = 1
    for k in sorted(set(d2) - set(d1)):
        print(f"+ {k}: {d2[k]}")
        diff = 1
    for k in sorted(set(d1) & set(d2)):
        if d1[k] != d2[k]:
            print(f"~ {k}: {d1[k]} -> {d2[k]}")
            diff = 1
    if not diff:
        print("configs identical")
    return diff


if __name__ == "__main__":
    sys.exit(main() or 0)
