"""Base factorization-model interface and init/shape helpers.

Port of ``recoder_tpu/models/base.py``. Every model pads its item axis
to a multiple of ``LANE_ALIGN`` with at least one extra sentinel row
(index ``num_items``). The port keeps that layout, although Hopper has
no 128-lane tiling, so that parameters and checkpoints have the JAX
shapes; the sentinel and pad rows are initialized like real rows and
masked out of every loss and every recommendation.
"""

import math

import numpy as np
import torch
from torch import nn

from recoder_tpu_torch.ops import noised_input as ni
from recoder_tpu_torch.ops.gather_matmul import (bf16_operand, row_sums,
                                                  take_rows)
# (the plain chain's two steps; the bottleneck and MF dropouts use dropout)
from recoder_tpu_torch.ops.noised_input import dropout, l2_normalize_rows


LANE_ALIGN = 256


def pad_dim(n, align=LANE_ALIGN):
  """Smallest multiple of ``align`` strictly greater than ``n``.

  Strictly greater so index ``n`` is always a valid sentinel row.
  """
  return ((int(n) + 1 + align - 1) // align) * align


def activation(x, act):
  """Apply an activation by name ('none' or a torch function name such
  as 'tanh', 'relu', 'sigmoid')."""
  if act == 'none':
    return x
  fn = getattr(torch.nn.functional, act, None)
  if fn is None:
    fn = getattr(torch, act)
  return fn(x)


def xavier_uniform(shape, fan_in, fan_out, generator=None):
  """torch-style xavier_uniform_ (gain=1) with explicit fans:
  U(-a, a), a = sqrt(6 / (fan_in + fan_out)).

  Padded tables pass their *logical* fans, so the init scale matches an
  unpadded table's.
  """
  limit = math.sqrt(6.0 / (fan_in + fan_out))
  return torch.empty(shape, dtype=torch.float32).uniform_(
      -limit, limit, generator=generator)


def linear(z, w, bias, compute_dtype=None):
  """``z @ w + bias`` of a hidden layer: in float32 (a bf16 weight
  upcast, as JAX promotes it), or (bf16 compute) the product of the
  bf16-rounded operands rounded to bf16, then float32 plus the bias (the
  JAX ``(z.astype(cd) @ w.astype(cd)).astype(float32) + b``; ``w`` a
  training step's working copy where it has one, ``ops/gather_matmul.
  bf16_operand``)."""
  if compute_dtype in (None, torch.float32):
    return z.float() @ w.float() + bias
  return (z.to(compute_dtype) @ bf16_operand(w, compute_dtype)).float() + bias


def coo_encode(table, rows, cols, vals, num_rows, compute_dtype=None):
  """``l2_normalize_rows(x) @ table`` of the ``[num_rows, N]`` input whose
  nonzeros are the COO ``(rows, cols, vals)``, without densifying it
  (the JAX models' ``encode_coo``): each row's norm is a sum of squares
  over its values, and the product is the row sum of ``table[cols]``
  scaled by the normalized values -- the zero columns of a dense row add
  exactly zero. At bf16 compute the rows and the scales are rounded to
  bf16 and so is their product; the sums are float32."""
  vals = vals.float()
  norm = torch.clamp(torch.sqrt(row_sums(vals * vals, rows, num_rows)),
                     min=1e-12)
  zv = vals / norm[torch.clamp(rows.long(), max=num_rows - 1)]
  en_rows = table.index_select(0, cols)
  if compute_dtype is not None:
    en_rows, zv = en_rows.to(compute_dtype), zv.to(compute_dtype)
  return row_sums((en_rows * zv[:, None]).float(), rows, num_rows)


#: parameter storage dtypes by name; ``Recoder.train`` trains float32 and
#: bfloat16 and refuses the others, as the JAX package does
PARAMS_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16,
                 'float16': torch.float16}


def check_params_dtype(params_dtype):
  """The storage dtype of the JAX models' ``params_dtype`` (None:
  float32), as a torch dtype. float16 is accepted here, as the JAX
  models accept it, and refused by ``Recoder.train``."""
  if params_dtype is None:
    return torch.float32
  dtype = (PARAMS_DTYPES.get(params_dtype) if isinstance(params_dtype, str)
           else params_dtype)
  if dtype not in PARAMS_DTYPES.values():
    raise ValueError(f'params_dtype={params_dtype!r}: one of '
                     f'{sorted(PARAMS_DTYPES)}')
  return dtype


def default_compute_dtype(compute_dtype, params_dtype):
  """The JAX models' rule: ``compute_dtype`` defaults to the
  ``params_dtype`` given (bf16 tables are multiplied in bf16, never
  upcast). float16 storage, which only serves (``Recoder.train`` refuses
  it), keeps float32 compute."""
  if compute_dtype is None and params_dtype is not None:
    dtype = check_params_dtype(params_dtype)
    return None if dtype == torch.float16 else dtype
  return compute_dtype


def adapt_array(ref, arr):
  """A checkpoint array (numpy, float32) as a tensor for the leaf
  ``ref``: its dtype, rounded to nearest even, and its device (the JAX
  ``_adapt_array``'s cast; shapes already match, since the port has no
  feature pad)."""
  t = torch.from_numpy(np.asarray(arr))
  if tuple(t.shape) != tuple(ref.shape):
    raise ValueError(f'array of shape {tuple(t.shape)} does not fit '
                     f'{tuple(ref.shape)}')
  return t.to(device=ref.device, dtype=ref.dtype)


def take_table_rows(model, path, ids, shard=None):
  """``model``'s table ``path`` at the rows ``ids`` (the whole table for
  None); on a mesh (``shard``, a ``parallel.sharding.Partition``) the
  rank's rows of them (:meth:`Partition.take`)."""
  table = getattr(model, path)
  return (take_rows(table, ids) if shard is None
          else shard.take(path, table, ids))


def noised_input(x, rate, generator=None, keep_mask=None, rows=None):
  """The encoder's input: ``x``'s rows L2-normalized, then the noise
  (inverted dropout at ``rate``; 0: the normalization alone), as
  ``dropout(l2_normalize_rows(x), rate, generator, keep_mask, rows)``.

  bf16 rows on the card outside a mesh (``rows`` None) take the
  ``noised_input`` kernel, one pass; the mask is drawn as the plain chain
  draws it, over the whole ``[B, W]`` from ``generator`` (one byte an
  element: the same bits and Philox offset as the bf16 draw), or is the
  given ``keep_mask``. Everything else (float32 rows, a mesh rank's rows,
  the CPU) takes the plain chain."""
  if rows is None and ni.takes(x):
    if rate > 0 and keep_mask is None:
      keep_mask = torch.empty(x.shape, dtype=ni.MASK_DTYPE,
                              device=x.device).bernoulli_(
                                  1.0 - rate, generator=generator)
    elif rate > 0:
      keep_mask = keep_mask.bool()
    return ni.noised_input_kernel(x, rate, keep_mask if rate > 0 else None)
  return ni.noised_input_plain(x, rate, generator, keep_mask, rows)


class FactorizationModel(nn.Module):
  """Base class for factorization models.

  Subclasses implement ``init_model`` (creating the parameters under
  their JAX names), ``model_params``, ``load_model_params`` and
  ``forward``, and set ``num_items``, ``num_items_padded`` (the width of
  the dense inputs and scores, ``pad_dim(num_items)``) and, for a
  user-indexed model, ``num_users`` in ``init_model``.

  ``forward(input, input_users=None, input_items=None,
  target_users=None, target_items=None, generator=None,
  training=False)`` is the port's form of the JAX ``apply(params,
  input, input_users, input_items, target_users, target_items, rng,
  training)`` (``recoder_tpu/models/base.py``): the parameters live on
  the module, and a ``torch.Generator`` on the input's device takes the
  place of ``rng`` for dropout noise when ``training``.

  Args of ``forward``:
    input (torch.Tensor [B, W]): dense interactions over the whole
      padded catalog (W = ``num_items_padded``) or over the item union
      ``input_items``.
    input_users / input_items / target_users / target_items: int64 id
      vectors on the input's device selecting embedding rows, or None
      for the whole table. The trainer passes the batch's user ids as
      ``input_users`` (pad slots hold ``num_users``, a row that
      ``pad_dim`` always provides) in training, scoring and
      recommending.

  It returns the ``[B, T]`` scores of the ``target_items`` columns (all
  ``num_items_padded`` of them when None). The built-in models also
  accept ``compute_dtype``; the trainer passes it only when
  ``eval_compute_dtype`` is set, so a model written to exactly this
  signature keeps working. A model with ``fused_decode``
  (:class:`DynamicAutoencoder`, :class:`MatrixFactorization`) trains
  through its ``decode_operands`` instead, and with it the fused
  decode-loss kernel; every other model trains through ``forward`` and
  the trainer's loss. A model on a mesh defines ``decode_operands``
  (``(h, rows, bias)`` of its scores ``h @ rows.T + bias``, with
  ``shard``): the trainer scores through it.
  """

  def init_model(self, num_items=None, num_users=None, seed=0):
    """Create the parameters for a catalog of ``num_items``/``num_users``."""
    raise NotImplementedError

  def model_params(self):
    """Hyper-parameters dict, stored in checkpoints."""
    raise NotImplementedError

  def load_model_params(self, model_params):
    """Restore hyper-parameters from a checkpoint dict."""
    raise NotImplementedError

  #: whether the trainer runs the model on a mesh (``Recoder(mesh=...)``)
  supports_mesh = False
  #: whether the trainer trains the model through ``decode_operands`` and
  #: the fused decode-loss kernel (else through ``forward`` and its loss)
  fused_decode = False

  def param_axes(self):
    """Map param-path -> axis-name tuple (e.g. ('item', 'embed')): the
    'item' and 'user' axes are split over a mesh's 'model' axis
    (``parallel/sharding.py``)."""
    raise NotImplementedError

  def sparse_param_paths(self):
    """Parameters trained by row-sparse Adam (none by default)."""
    return ()

  def encode_coo(self, rows, cols, vals, num_rows, input_users=None,
                 compute_dtype=None):
    """Optional: the inference hidden state ``h [num_rows, ...]`` of a
    batch given as COO interactions (``rows`` in ``[0, num_rows)``; a
    row id of ``num_rows`` is a pad slot), never densified over the
    catalog. With :meth:`decode_slice` it serves chunked scoring
    (``Recoder(eval_item_chunk=...)``), whose memory is ``O(B x
    chunk)`` instead of ``O(B x num_items)``."""
    raise NotImplementedError(
        f'{type(self).__name__} does not support chunked inference')

  def decode_slice(self, h, start, width, compute_dtype=None):
    """Optional: float32 scores ``[B, width]`` of the contiguous catalog
    slice ``[start, start + width)`` from :meth:`encode_coo`'s ``h``."""
    raise NotImplementedError(
        f'{type(self).__name__} does not support chunked inference')

  def params(self):
    """``{jax_name: parameter}`` -- the names the checkpoint uses."""
    return dict(self.named_parameters())

  def register_params(self, params):
    """Replace the module's parameters by ``params`` ({name: float32
    tensor}), in order, each rounded once (to nearest even) to the
    model's ``params_dtype`` (float32 when it has none); the tables of
    :meth:`sparse_param_paths` do not require grad (row-sparse Adam
    trains them outside autograd)."""
    self._parameters.clear()
    sparse = self.sparse_param_paths()
    dtype = getattr(self, 'params_dtype', torch.float32)
    for name, value in params.items():
      self.register_parameter(
          name, nn.Parameter(value.to(dtype),
                             requires_grad=name not in sparse))
    return self.params()
