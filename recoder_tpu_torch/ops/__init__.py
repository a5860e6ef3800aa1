"""Tensor operations: losses, the encode/decode products and the fused
decode-loss kernel."""
