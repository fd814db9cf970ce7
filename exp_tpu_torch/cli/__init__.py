"""Standalone command-line tools (the reference's utils/ toolbox; port of
exp_tpu/cli).

Each tool runs as `python -m exp_tpu_torch.cli.<tool>` or through the
umbrella, `python -m exp_tpu_torch.cli <tool> ...`, with exp_tpu's flags,
on the CUDA card unless `--cpu` is given.  The tools ported so far:

  ICs:  gensph (utils/ICs/gensph; --qp QPDistF, --ebar ellipsoidal bar,
        --adddisk, --addsphere), gendisk2d (the Disk2dHalo path via
        --nhalo), zangics (tapered-Mestel Zang disk)

exp_tpu's other tools are ROADMAP item 14b.
"""

TOOLS = ["gensph", "gendisk2d", "zangics"]
