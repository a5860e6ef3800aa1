"""Tensor operations: losses, the encode/decode products, and the
wrappers of the hand-written kernels (each beside its plain version)."""
