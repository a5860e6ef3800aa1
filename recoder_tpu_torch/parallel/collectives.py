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
    row and column shares of uneven sizes (scoring, checkpoints);
    :func:`gather_rows_to_host`, a whole matrix on one rank's host, one
    row share at a time (a checkpoint too large for a card);
    :func:`gather_columns_grad`, the same whose backward hands each rank
    its own columns' gradient (a custom loss over a split catalog);
  * :func:`sum_over`, :func:`reduce_to`, :func:`broadcast_from`: sums and
    copies without a gradient (the fits' slabs and row blocks, the data
    source's owner-slice fetches).

Each is a ``torch.distributed`` call on the group's backend: NCCL on the
card, whose collectives a CUDA graph records once the communicator is
warm, and gloo on the CPU (and, in tests of one card, on CUDA tensors,
eagerly). A group of one rank returns its input exactly.
"""

import numpy as np
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


def sum_over(x, group):
  """The elementwise sum over the group (no gradient)."""
  return _all_reduce(x.detach(), group)


def _staged(x, group):
  """Whether ``x`` goes through the host for a collective that gloo
  runs on CPU tensors only (reduce, on a card's tensor)."""
  return x.is_cuda and dist.get_backend(group) == 'gloo'


def reduce_to(x, dst, group):
  """Add the group's ``x`` into group rank ``dst``'s ``x``, in place (the
  other ranks' ``x`` is left undefined); returns ``x``. Over gloo a
  card's tensor is staged through the host."""
  if dist.get_world_size(group) == 1:
    return x
  dst = dist.get_global_rank(group, dst) if group is not None else dst
  if _staged(x, group):
    host = x.cpu()
    dist.reduce(host, dst, group=group)
    return x.copy_(host)
  dist.reduce(x, dst, group=group)
  return x


def broadcast_from(x, src, group):
  """Group rank ``src``'s ``x`` into every rank's ``x``, in place;
  returns ``x``."""
  if dist.get_world_size(group) == 1:
    return x
  src = dist.get_global_rank(group, src) if group is not None else src
  dist.broadcast(x, src, group=group)
  return x


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


def gather_rows_to_host(x, group, sizes, dst=0):
  """The group's ``x`` stacked along the first axis in rank order, as a
  numpy array on group rank ``dst`` (None elsewhere). Each rank's share
  is broadcast by its owner in turn and copied to ``dst``'s host, so that
  no device holds more than one share (``sizes``: the row counts)."""
  me = dist.get_rank(group)
  out, lo = None, 0
  for j, rows in enumerate(sizes):
    block = broadcast_from(x.contiguous() if j == me
                           else x.new_empty((rows, *x.shape[1:])), j, group)
    if me == dst:
      host = block.cpu().numpy()
      if out is None:
        out = np.empty((sum(sizes), *host.shape[1:]), host.dtype)
      out[lo:lo + rows] = host
    del block
    lo += rows
  return out


def gather_columns(x, group, sizes):
  """The group's ``x [B, w_r]`` side by side along the second axis, in
  rank order (``sizes``: the ``w_r``)."""
  return gather_rows(x.t(), group, sizes).t()


class _GatherColumns(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, group, sizes):
    rank = dist.get_rank(group)
    ctx.lo = sum(sizes[:rank])
    ctx.width = sizes[rank]
    return gather_columns(x.detach(), group, sizes)

  @staticmethod
  def backward(ctx, g):
    return g[:, ctx.lo:ctx.lo + ctx.width], None, None


def gather_columns_grad(x, group, sizes):
  """:func:`gather_columns`, differentiable: every rank computes the same
  function of the whole matrix, and each rank's backward takes the
  gradient of its own columns (a group of one returns ``x``)."""
  if dist.get_world_size(group) == 1:
    return x
  return _GatherColumns.apply(x, group, sizes)
