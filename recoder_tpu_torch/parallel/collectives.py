"""The collectives of a mesh step, with the gradients they need.

JAX lets XLA place a mesh step's collectives; the port places them
(``parallel/sharding.Partition``, ``model.Recoder``) with these:

  * :func:`sum_forward`: the sum over a group in the forward pass, the
    gradient passed through (the encoder's partial products, a loss's
    partial sums);
  * :func:`sum_backward`: the input as it is, the gradients added over
    the group in the backward pass (the bottleneck that each 'model' rank
    decodes against its own columns);
  * :func:`sum_both`: a sum whose every rank's output feeds the loss, so
    the backward adds too (logloss's normalizer over the columns);
  * :func:`all_reduce_grads`: the gradients of parameters that several
    ranks train added in place (over 'data');
  * :func:`gather_rows`, :func:`gather_columns`: whole tensors from
    row and column shares of uneven sizes (scoring, checkpoints).

Each is a ``torch.distributed`` call on the group's backend: NCCL on the
card, whose collectives a CUDA graph records once the communicator is
warm, and gloo on the CPU (and, in tests of one card, on CUDA tensors,
eagerly). A group of one rank returns its input exactly.
"""

import torch
import torch.distributed as dist


def _all_reduce(x, group, op=dist.ReduceOp.SUM):
  out = x.contiguous().clone()
  dist.all_reduce(out, op=op, group=group)
  return out


class _SumForward(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, group):
    return _all_reduce(x, group)

  @staticmethod
  def backward(ctx, g):
    return g, None


class _SumBackward(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, group):
    ctx.group = group
    return x.view_as(x)

  @staticmethod
  def backward(ctx, g):
    return _all_reduce(g, ctx.group), None


class _SumBoth(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, group):
    ctx.group = group
    return _all_reduce(x, group)

  @staticmethod
  def backward(ctx, g):
    return _all_reduce(g, ctx.group), None


def sum_forward(x, group):
  """``sum over the group of x``; the backward passes the gradient
  through to this rank's ``x``."""
  return _SumForward.apply(x, group)


def sum_backward(x, group):
  """``x``; the backward adds the group's gradients of it."""
  return _SumBackward.apply(x, group)


def sum_both(x, group):
  """``sum over the group of x``; the backward adds the group's
  gradients of the sum (every rank's loss reads it)."""
  return _SumBoth.apply(x, group)


def max_over(x, group):
  """The elementwise maximum over the group (no gradient)."""
  return _all_reduce(x.detach(), group, dist.ReduceOp.MAX)


def all_reduce_grads(tensors, group):
  """Add the gradients of ``tensors`` over the group, in place (a tensor
  without a gradient is skipped: every rank skips it alike)."""
  for t in tensors:
    if t.grad is not None:
      dist.all_reduce(t.grad, group=group)


def gather_rows(x, group, sizes):
  """The group's ``x`` stacked along the first axis in rank order;
  ``sizes``: each rank's row count, which may differ (each is padded to
  the largest for the exchange, then cut)."""
  n = dist.get_world_size(group)
  if n == 1:
    return x
  pad = max(sizes) - x.shape[0]
  x = x.contiguous()
  if pad:
    x = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])
  parts = [torch.empty_like(x) for _ in range(n)]
  dist.all_gather(parts, x, group=group)
  return torch.cat([p[:s] for p, s in zip(parts, sizes)])


def gather_columns(x, group, sizes):
  """The group's ``x [B, w_r]`` side by side along the second axis, in
  rank order (``sizes``: the ``w_r``)."""
  return gather_rows(x.t(), group, sizes).t()
