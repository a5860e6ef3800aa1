"""Peaks, kernel bounds and batch counts: the benchmark's own arithmetic.

``bound``, ``decode_loss_bounds`` and the Adam byte count are frozen
copies of ``chip_smoke.py``'s (each input counted read once, each output
written once; products at the tensor-core peak of their operand type). :func:`group_stats` counts each batch's users,
interactions and item union from the matrix and the cell's sampling
alone, never from the program; each model's reference module turns them
into that model's FLOPs.
"""

import math

import torch

#: published dense peaks of one H100 SXM at its 700 W limit: bf16 and
#: TF32 tensor cores, HBM3
PEAK_FLOPS = {'bfloat16': 989e12, 'float32': 495e12}
PEAK_BYTES = 3.35e12
#: the bytes Adam moves a parameter: float32 parameter read and written,
#: float32 gradient read, bf16 m and v read and written
ADAM_BYTES_PER_PARAM = 20.0


def bound(flops, nbytes, peak_flops):
  """``(least ms on the card, what sets it)``: operations at
  ``peak_flops`` against bytes at the HBM peak."""
  ops_ms, mem_ms = flops / peak_flops * 1e3, bytes_ms(nbytes)
  return (ops_ms, 'operations') if ops_ms >= mem_ms else (mem_ms, 'bytes')


def decode_loss_bounds(B, d, W, target_bytes=4, bf16=False, param_bytes=4):
  """Bounds of the fused decode-loss forward (the loss and the E0 stash
  ``[B, W rounded up]``) and backward (two products over E0 to dh,
  drows and dbias), from what each reads and writes once and the
  products it does; ``bf16``: E0 in bf16 and the products at the bf16
  peak."""
  product = 2.0 * B * W * d
  lde, e0_bytes = (-(-W // 8) * 8, 2.0) if bf16 else (-(-W // 4) * 4, 4.0)
  peak = PEAK_FLOPS['bfloat16' if bf16 else 'float32']
  pb = float(param_bytes)
  inputs = 4.0 * (B * d + W + B) + pb * (W * d + W) + target_bytes * B * W
  grads = 4.0 * B * d + pb * (W * d + W)
  return {'fwd': bound(product, inputs + 4 + e0_bytes * B * lde, peak),
          'bwd': bound(2 * product, e0_bytes * B * lde
                       + 4.0 * B * d + pb * W * d + 4 + grads, peak)}


def bytes_ms(nbytes):
  """The least ms in which the card moves ``nbytes`` to or from HBM."""
  return nbytes / PEAK_BYTES * 1e3


def adam_bound_ms(n_params):
  """The bf16-moment Adam step's bound over ``n_params`` parameters."""
  return bytes_ms(ADAM_BYTES_PER_PARAM * n_params)


def pad_dim(n, align=256):
  """The padded catalog width: the smallest multiple of ``align``
  strictly above ``n`` (index ``n`` is then a sentinel row)."""
  return ((int(n) + align) // align) * align


def group_stats(matrix, order, batch_size, device):
  """``(users, nnz, union)`` of each consecutive group of ``batch_size``
  users of ``order`` (every user of the matrix once, and pad ids past it
  that count as users without items): valid users, interactions and
  distinct items, each a 1-D int64 tensor on ``device``."""
  n, m = matrix.shape
  order = torch.as_tensor(order, dtype=torch.int64, device=device)
  groups = math.ceil(order.numel() / batch_size)
  position = torch.arange(order.numel(), device=device)
  valid = order < n
  group_of = torch.full((n,), -1, dtype=torch.int64, device=device)
  group_of[order[valid]] = position[valid] // batch_size
  users = torch.bincount(position[valid] // batch_size, minlength=groups)
  indptr = torch.as_tensor(matrix.indptr, dtype=torch.int64, device=device)
  indices = torch.as_tensor(matrix.indices, dtype=torch.int64, device=device)
  owner = torch.repeat_interleave(group_of, indptr[1:] - indptr[:-1])
  nnz = torch.bincount(owner, minlength=groups)
  keys = torch.unique(owner * m + indices)
  union = torch.bincount(torch.div(keys, m, rounding_mode='floor'),
                         minlength=groups)
  return users, nnz, union

