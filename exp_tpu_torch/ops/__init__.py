"""Tensor helpers and the hand-written Hopper kernels of the port."""
