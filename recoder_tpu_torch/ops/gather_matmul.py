"""Encode and decode products of the autoencoder's embedding tables.

Port of the dense (``ids=None``) case of ``recoder_tpu/ops/gather_matmul.py``:
the full-catalog path multiplies by the whole table, so no row gather
happens. Both products stay ``torch.matmul`` in float32 -- the JAX
package computes them outside any Pallas kernel too. The training step
for 'mse' and 'logistic' does not call :func:`decode_matmul`: the fused
decode-loss kernel (``ops/fused_decode_loss.py``) computes the decode
and the loss in one pass.
"""

import torch


def encode_matmul(z, table, bias):
  """``z[B, W] @ table[W, d] + bias[d]``."""
  return torch.matmul(z, table) + bias


def decode_matmul(h, table, bias):
  """``h[B, d] @ table[W, d].T + bias[W]``."""
  return torch.matmul(h, table.t()) + bias
