"""Analysis containers (port of exp_tpu/analysis; only `coefs` so far, the
playback source of the driver — the rest is ROADMAP item 14)."""
