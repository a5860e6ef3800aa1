"""Row gathers and the encode and decode products of the autoencoder's
embedding tables.

Port of ``recoder_tpu/ops/gather_matmul.py``: :func:`take_rows` gathers
a union's rows with ``index_select`` (its backward scatters into the
whole table), and the products are library calls -- the JAX package
computes them outside any Pallas kernel too. The JAX
``encode_gather_matmul`` / ``decode_gather_matmul`` are
:func:`take_rows` followed by these products (the model composes them).
The training step for 'mse' and 'logistic' does not call
:func:`decode_matmul`: the fused decode-loss kernel
(``ops/fused_decode_loss.py``) computes the decode and the loss in one
pass.

``compute_dtype='bfloat16'`` follows the JAX package's
``jnp.dot(a.astype(bf16), b.astype(bf16),
preferred_element_type=float32)``: both operands are rounded to bf16
and the product is accumulated and returned in float32
(:func:`matmul_f32_out`), then the float32 bias is added. On the card
that is one cuBLAS bf16 GEMM with a float32 output (``torch.mm(...,
out_dtype=torch.float32)``); on the CPU, which has no such kernel, the
float32 product of the bf16-rounded operands (the same products, summed
in another order).

The weight's gradient leaves cuBLAS as bf16 in the weight's own layout:
``a.t() @ g`` for an operand ``b`` laid out row-major, and for the
decoder's ``table.t()`` the swapped product ``g.t() @ a``, which lands in
the table's ``[W, d]`` rows (on the CPU the float32 product rounded: the
same values).

A training step's float32 weight that a bf16 product reads whole may
have a bf16 working copy (:func:`working_copies`, kept by
``optim.Bf16Adam``, which writes it when it steps the weight, so that it
is always ``p.to(bf16)``): the product reads the copy in place of
``p.to(bf16)``, and the weight's bf16 gradient stays on the copy, where
the optimizer reads it, in place of its upcast to float32 on ``p``. The
values are the same; the casts are gone.

bf16 parameter storage: a bf16 table enters the bf16 product as it is
(its ``.to(bf16)`` is no copy), and its gradient is the bf16 one the
product's backward rounds once from float32 -- the transpose of the JAX
``astype``. The gather's backward (``index_select``'s) accumulates in the
table's dtype, as the JAX scatter-add of a bf16 cotangent does.
"""

import contextlib
import contextvars

import torch

BF16 = torch.bfloat16

#: the working copies of the training step under way: a function of a
#: float32 tensor that returns its bf16 working copy or None
#: (:func:`working_copies`)
_WORKING = contextvars.ContextVar('working_copies', default=None)


@contextlib.contextmanager
def full_float32():
  """float32 products without TF32 for the duration (the JAX
  ``Precision.HIGHEST``); the previous precision is restored after."""
  prev = torch.get_float32_matmul_precision()
  torch.set_float32_matmul_precision('highest')
  try:
    yield
  finally:
    torch.set_float32_matmul_precision(prev)


def as_dtype(dtype):
  """``None`` (float32 compute) or a torch floating dtype, from a dtype or
  its name ('bfloat16', 'float32')."""
  if dtype is None:
    return None
  if isinstance(dtype, str):
    dtype = getattr(torch, dtype, None)
  if dtype not in (torch.float32, BF16):
    raise ValueError(f'compute dtype {dtype!r}: float32 or bfloat16')
  return dtype


def take_rows(table, ids):
  """``table[ids]`` along the first axis (the whole table when ``ids``
  is None); ids are in bounds by the data pipeline's guarantee."""
  if ids is None:
    return table
  return table.index_select(0, ids)


def row_sums(values, rows, num_rows):
  """``[num_rows, ...]`` sums of ``values`` by COO row (the JAX
  ``segment_sum(values, rows, num_rows + 1)[:num_rows]``: a row id of
  ``num_rows`` or more is a pad slot, dropped).

  Each row's values are added in the COO's order (``torch.segment_reduce``
  over a stable sort of ``rows``; a CSR batch is sorted already), so the
  sums are the same on every run, on the card too, where an
  ``index_add_`` would add in the order its atomics land."""
  rows = torch.clamp(rows.long(), max=num_rows)
  order = torch.argsort(rows, stable=True)
  bounds = torch.searchsorted(
      rows[order], torch.arange(num_rows + 2, device=rows.device))
  sums = torch.segment_reduce(values[order], 'sum',
                              lengths=torch.diff(bounds), axis=0,
                              unsafe=True)
  return sums[:num_rows]


@contextlib.contextmanager
def working_copies(copy_of):
  """Within the block, a bf16 product that reads a float32 weight whole
  takes ``copy_of(weight)`` as its operand where that is not None: a bf16
  working copy equal to ``weight.to(bf16)`` (``optim.Bf16Adam.
  working_copy``), whose gradient the backward pass leaves in bf16."""
  token = _WORKING.set(copy_of)
  try:
    yield
  finally:
    _WORKING.reset(token)


def bf16_operand(w, compute_dtype):
  """The weight ``w`` as a product's operand in ``compute_dtype``: its
  working copy where the training step under way has one, else
  ``w.to(compute_dtype)``."""
  copy_of = _WORKING.get()
  if copy_of is not None and compute_dtype == BF16:
    copy = copy_of(w)
    if copy is not None:
      return copy
  return w.to(compute_dtype)


def _mm_f32(a, b):
  if a.device.type == 'cuda':
    return torch.mm(a, b, out_dtype=torch.float32)
  return torch.mm(a.float(), b.float())


@contextlib.contextmanager
def _float32_sums():
  """bf16-output products whose sums stay float32 for the duration:
  cuBLAS may split K, but reduces the parts in float32, never in the bf16
  output (PyTorch allows that by default); the previous setting is
  restored after."""
  matmul = torch.backends.cuda.matmul
  prev = now = matmul.allow_bf16_reduced_precision_reduction
  try:  # (a torch with the split-K half of the setting keeps that half)
    prev = (prev, matmul.allow_bf16_reduced_precision_reduction_split_k)
    now = (False, prev[1])
  except AttributeError:
    now = False
  matmul.allow_bf16_reduced_precision_reduction = now
  try:
    yield
  finally:
    matmul.allow_bf16_reduced_precision_reduction = prev


def _weight_grad(a, g, b):
  """The bf16 gradient ``a.t() @ g`` of the operand ``b`` of ``a @ b``,
  laid out as ``b`` is: for a transposed operand (the decoder's
  ``table.t()``) the transpose of ``g.t() @ a``, which fills the table's
  rows. On the card one bf16-output GEMM with float32 sums, rounded once
  to bf16 as ``_mm_f32(a.t(), g).to(bf16)`` is (the card tests hold it to
  those bits at the training shapes, a mega-batch's and a union's); on
  the CPU that rounded product."""
  if a.device.type != 'cuda':
    return _mm_f32(a.t(), g).to(BF16)
  with _float32_sums():
    if not b.is_contiguous() and b.t().is_contiguous():
      return torch.mm(g.t(), a).t()
    return torch.mm(a.t(), g)


class _MatmulF32Out(torch.autograd.Function):
  """``a @ b`` of two bf16 matrices, accumulated and returned in float32.

  The gradients are bf16, as the cotangents of bf16 operands are in JAX.
  The float32 upstream gradient is rounded to bf16 before the transposed
  products, as XLA:TPU's default-precision dot does (JAX on the CPU
  multiplies it in float32; the difference is one bf16 rounding of an
  input, below the rounding of the result)."""

  @staticmethod
  def forward(ctx, a, b):
    ctx.save_for_backward(a, b)
    return _mm_f32(a, b)

  @staticmethod
  def backward(ctx, g):
    a, b = ctx.saved_tensors
    g = g.to(BF16)
    da = db = None
    if ctx.needs_input_grad[0]:
      da = _mm_f32(g, b.t()).to(BF16)
    if ctx.needs_input_grad[1]:
      db = _weight_grad(a, g, b)
    return da, db


def matmul_f32_out(a, b, compute_dtype=None):
  """``a @ b`` in ``compute_dtype`` with a float32 result (float32
  throughout when ``compute_dtype`` is None or float32)."""
  cd = as_dtype(compute_dtype)
  if cd in (None, torch.float32):
    # (a bf16 input of a float32 product is upcast, as JAX promotes it)
    return torch.matmul(a.float(), b.float())
  return _MatmulF32Out.apply(a.to(cd), bf16_operand(b, cd))


def encode_matmul(z, table, bias, compute_dtype=None):
  """``z[B, W] @ table[W, d] + bias[d]``."""
  return matmul_f32_out(z, table, compute_dtype) + bias


def decode_matmul(h, table, bias, compute_dtype=None):
  """``h[B, d] @ table[W, d].T + bias[W]``."""
  cd = as_dtype(compute_dtype)
  if cd in (None, torch.float32):
    return matmul_f32_out(h, table.t()) + bias
  return _MatmulF32Out.apply(h.to(cd), bf16_operand(table, cd).t()) + bias
