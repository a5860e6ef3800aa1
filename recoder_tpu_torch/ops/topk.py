"""Top-k over the last axis in ``lax.top_k``'s order.

The counterpart, by function, of ``recoder_tpu/ops/topk.py``: the
recommend and evaluation paths take their top-k here. It returns what
``lax.top_k`` returns -- values descending, equal values by lowest
index, in the total order of floats that XLA sorts by (``-NaN < -inf <
... < -0.0 < +0.0 < ... < +inf < NaN``: a NaN ranks first, and +0.0
above -0.0). ``torch.topk`` finds the same set up to ties but orders
and picks ties by no rule, not even on the CPU, so a row with ties --
a bf16 score row, an all -inf tail -- would rank differently from the
JAX package (and pick pad columns of a user with fewer than k unseen
items).

The design is one ``torch.topk`` over int64 keys: the high 32 bits order
the floats as XLA does (:func:`order_key`), the low 32 bits hold ``W - 1
- index``, so every key is distinct and the largest k keys are
``lax.top_k``'s k elements in its order. No branch and no host read, so
a caller on the card stays asynchronous.

The JAX package's ``'exact'`` mode is a count-certified fast path that
exists because ``lax.top_k`` is slow on the TPU; it is not ported (a
TPU-only workaround). Every mode of :data:`MODES` is this exact top-k:
``'sort'`` is plain ``lax.top_k`` in JAX, and ``'approx'``
(``lax.approx_max_k``) returns ``lax.top_k``'s result on every backend
but the TPU. ``Recoder`` checks its ``eval_topk`` against them.
"""

import torch

MODES = ('exact', 'sort', 'approx')


def order_key(scores):
  """int32 keys of ``scores`` (float32 or narrower, upcast exactly) whose
  integer order is the floats' total order (the one ``lax.top_k`` ranks
  by): a negative float's magnitude bits are flipped."""
  bits = scores.float().contiguous().view(torch.int32)
  return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def top_k(scores, k):
  """``lax.top_k(scores, k)``: ``(values [..., k], indices [..., k])``
  over the last axis, values in ``scores``' dtype, indices int64."""
  width = scores.shape[-1]
  lead = scores.shape[:-1]
  s = scores.reshape(-1, width)
  k = int(k)
  if k > width:
    raise ValueError(f'k ({k}) exceeds the row width ({width})')
  tie_break = width - 1 - torch.arange(width, device=s.device)
  idx = torch.topk((order_key(s).long() << 32) | tie_break, k, dim=1).indices
  return s.gather(1, idx).reshape(*lead, k), idx.reshape(*lead, k)


def merge_top_k(vals_a, idx_a, vals_b, idx_b, k):
  """The running top-k merge of chunked scoring (the JAX ``merge_loop``
  body): the best ``k`` of two ``[B, *]`` candidate sets by (value desc,
  index asc), in :func:`top_k`'s order of floats, through the same int64
  keys (an index is below 2^32). (The JAX merge sorts with ``lax.sort``,
  which holds -0.0 equal to +0.0 and ranks a NaN last; both packages'
  chunked and monolithic paths may differ on a NaN row.)"""
  vals = torch.cat([vals_a, vals_b], dim=1)
  idx = torch.cat([idx_a, idx_b], dim=1)
  key = (order_key(vals).long() << 32) | (0xFFFFFFFF - idx)
  pos = torch.topk(key, k, dim=1).indices
  return vals.gather(1, pos), idx.gather(1, pos)
