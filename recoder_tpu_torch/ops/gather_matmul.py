"""Row gathers and the encode and decode products of the autoencoder's
embedding tables.

Port of ``recoder_tpu/ops/gather_matmul.py``: :func:`take_rows` gathers
a union's rows with ``index_select`` (its backward scatters into the
whole table), and the products stay ``torch.matmul`` in float32 -- the
JAX package computes them outside any Pallas kernel too. The JAX
``encode_gather_matmul`` / ``decode_gather_matmul`` are
:func:`take_rows` followed by these products (the model composes them).
The training step for 'mse' and 'logistic' does not call
:func:`decode_matmul`: the fused decode-loss kernel
(``ops/fused_decode_loss.py``) computes the decode and the loss in one
pass.
"""

import torch


def take_rows(table, ids):
  """``table[ids]`` along the first axis (the whole table when ``ids``
  is None); ids are in bounds by the data pipeline's guarantee."""
  if ids is None:
    return table
  return table.index_select(0, ids)


def encode_matmul(z, table, bias):
  """``z[B, W] @ table[W, d] + bias[d]``."""
  return torch.matmul(z, table) + bias


def decode_matmul(h, table, bias):
  """``h[B, d] @ table[W, d].T + bias[W]``."""
  return torch.matmul(h, table.t()) + bias
