"""Dynamic autoencoder: the full-catalog path and the item-union path.

Port of ``recoder_tpu/models/autoencoder.py`` (``DynamicAutoencoder``)
as an ``nn.Module``:

  l2-normalize rows -> noise dropout -> encode (z @ E_en[items] + b_en)
  -> activation and hidden Linears (with bottleneck dropout)
  -> decode (h @ E_de[items].T + b_de[items])

With ``items`` None the products take the whole tables (full decode);
with an item union they take its gathered rows, so encode and decode
cost grows with the union, not with the catalog. Parameters keep the JAX
names and shapes (item tables padded to ``pad_dim(num_items)`` rows), so
``convert.py`` and the npz checkpoints move them either way.

:meth:`decode_operands` gives the bottleneck ``h`` with the decoder rows
and bias, so that the scores are ``h @ rows.T + bias``; the trainer hands
the three to the fused decode-loss kernel, and :meth:`decode` (under
:meth:`apply` / :meth:`apply_gathered` / :meth:`forward`) decodes them
with a matmul.

``sparse=True`` marks the embedding tables for row-sparse Adam
(:meth:`sparse_param_paths`): they are then not trained by autograd
through the module (``requires_grad`` is False); the trainer gathers
their union rows as leaves (:meth:`sparse_entries`), runs the forward on
them (``gathered``, as :meth:`apply_gathered` does) and writes the
updated rows back. The JAX package pads a sparse table's feature axis
to 128 lanes (``pad_features``) for XLA:TPU's row scatters; the port
keeps it [N, d0], and ``convert.py`` bridges the pad when a checkpoint
moves between the packages.

``compute_dtype='bfloat16'`` (bench.py's ML-20M default) follows the
JAX package's casts: the encode and decode round both operands to bf16
and accumulate in float32 (``ops/gather_matmul.py``), each hidden Linear
multiplies in bf16 and upcasts its product before the float32 bias, and
the scores leave the forward in bf16.

``params_dtype='bfloat16'`` stores every parameter in bf16 (the JAX
package's bf16 storage: half the table bytes, for catalogs near the
card's memory); ``compute_dtype`` then defaults to bf16, the tables
enter the products as they are stored, and each gradient comes back in
its parameter's dtype, rounded once from its float32 sum. The init draws
in float32 from the same generator and rounds once.

:meth:`encode_coo` and :meth:`decode_slice` serve chunked scoring: the
bottleneck from a COO batch, then the scores of one contiguous slice of
the catalog at a time.
"""

import torch
from torch import nn

from recoder_tpu_torch.models.base import (FactorizationModel, activation,
                                           check_params_dtype, coo_encode,
                                           default_compute_dtype, dropout,
                                           l2_normalize_rows,
                                           linear, pad_dim, xavier_uniform)
from recoder_tpu_torch.ops.gather_matmul import (as_dtype, decode_matmul,
                                                  encode_matmul, take_rows)


class DynamicAutoencoder(FactorizationModel):
  """Autoencoder over the item catalog (negative sampling friendly).

  Args:
    hidden_layers (list): encoder layer sizes; the first entry is the
      embedding dim, later entries are hidden encoder Linear widths.
      The decoder mirrors them.
    activation_type (str): activation name ('tanh', 'relu', ..., 'none').
    is_constrained (bool): tie decoder weights to encoder transposes.
    dropout_prob (float): bottleneck dropout.
    noise_prob (float): input (denoising) dropout.
    sparse (bool): train the embedding tables with row-sparse Adam
      (torch SparseAdam's rule; ``optim.SparseRowAdam``).
    compute_dtype (str, optional): the products' dtype ('bfloat16');
      sums stay float32. None keeps float32 compute end to end (or, with
      bf16 parameters, bf16). A checkpoint carries it, and a model
      constructed without one takes the checkpoint's on load.
    params_dtype (str, optional): the parameters' storage dtype
      ('bfloat16'; None: float32). A checkpoint stores them upcast to
      float32 and does not carry it: the constructor's restores it on
      load, rounding to nearest even (serve a float32 checkpoint from
      bf16 tables by loading it into such a model).
  """

  def __init__(self, hidden_layers=None, activation_type='tanh',
               is_constrained=False, dropout_prob=0.0, noise_prob=0.0,
               sparse=False, compute_dtype=None, params_dtype=None):
    super().__init__()
    self.sparse = bool(sparse)
    self.params_dtype = check_params_dtype(params_dtype)
    self.compute_dtype = as_dtype(default_compute_dtype(
        as_dtype(compute_dtype), params_dtype))
    self.hidden_layers = hidden_layers
    self.activation_type = activation_type
    self.is_constrained = is_constrained
    self.dropout_prob = dropout_prob
    self.noise_prob = noise_prob
    self.num_items = None
    self.num_items_padded = None

  # -- init / hyperparams ------------------------------------------------

  def init_model(self, num_items=None, num_users=None, seed=0):
    """Create the parameters (in ``params_dtype``, on the CPU; the
    trainer moves the module). The draws come in float32 from a CPU
    generator seeded with ``seed``, so the init does not depend on the
    device or the storage dtype."""
    if not self.hidden_layers:
      raise ValueError('hidden_layers must be a non-empty list')
    self.num_items = int(num_items)
    self.num_items_padded = pad_dim(self.num_items)
    d0 = self.hidden_layers[0]
    gen = torch.Generator().manual_seed(int(seed))
    params = {}
    # item tables: padded rows, logical fans
    params['en_embedding'] = xavier_uniform(
        (self.num_items_padded, d0), fan_in=d0, fan_out=self.num_items,
        generator=gen)
    params['en_bias'] = torch.zeros(d0)
    for i, width in enumerate(self.hidden_layers[1:], 1):
      prev = self.hidden_layers[i - 1]
      params[f'encode_w_{i}'] = xavier_uniform(
          (prev, width), fan_in=prev, fan_out=width, generator=gen)
      params[f'encode_bias_{i}'] = torch.zeros(width)
    rev = list(reversed(self.hidden_layers))
    for i, width in enumerate(rev[1:], 1):
      prev = rev[i - 1]
      if not self.is_constrained:
        params[f'decode_w_{i}'] = xavier_uniform(
            (prev, width), fan_in=prev, fan_out=width, generator=gen)
      params[f'decode_bias_{i}'] = torch.zeros(width)
    if not self.is_constrained:
      params['de_embedding'] = xavier_uniform(
          (self.num_items_padded, d0), fan_in=d0, fan_out=self.num_items,
          generator=gen)
    params['de_bias'] = torch.zeros(self.num_items_padded)

    return self.register_params(params)

  def model_params(self):
    p = {
        'hidden_layers': self.hidden_layers,
        'activation_type': self.activation_type,
        'is_constrained': self.is_constrained,
        'dropout_prob': self.dropout_prob,
        'noise_prob': self.noise_prob,
    }
    if self.compute_dtype is not None:
      p['compute_dtype'] = str(self.compute_dtype).removeprefix('torch.')
    return p

  def load_model_params(self, model_params):
    self.hidden_layers = model_params['hidden_layers']
    self.activation_type = model_params['activation_type']
    self.is_constrained = model_params['is_constrained']
    self.dropout_prob = model_params['dropout_prob']
    self.noise_prob = model_params['noise_prob']
    # the checkpoint's compute dtype, unless the constructor chose one
    # (an absent key: a float32 run or an older checkpoint)
    if self.compute_dtype is None and 'compute_dtype' in model_params:
      self.compute_dtype = as_dtype(model_params['compute_dtype'])

  def sparse_param_paths(self):
    """The tables row-sparse Adam trains when ``sparse`` (none
    otherwise)."""
    if not self.sparse:
      return ()
    return (('en_embedding',) if self.is_constrained
            else ('en_embedding', 'de_embedding'))

  def sparse_entries(self, input_users=None, input_items=None,
                     target_users=None, target_items=None):
    """Row-gather plan of the sparse step: ``[(name, table, ids)]`` (the
    user ids are not used: an item-based model). A
    decoder tied to the encoder that decodes the same union collapses
    into the one 'en_rows' entry, so both uses' gradients meet in one
    row-sparse update (torch's coalesced sparse gradient)."""
    entries = [('en_rows', 'en_embedding', input_items)]
    de_table = 'en_embedding' if self.is_constrained else 'de_embedding'
    if not (de_table == 'en_embedding' and target_items is input_items):
      entries.append(('de_rows', de_table, target_items))
    return entries

  # -- forward -----------------------------------------------------------

  def decoder_table(self):
    """The [num_items_padded, d0] table the decode multiplies by."""
    return self.en_embedding if self.is_constrained else self.de_embedding

  def _compute_dtype(self, compute_dtype):
    return self.compute_dtype if compute_dtype is None else as_dtype(
        compute_dtype)

  def _hidden_stack(self, z, training, generator, cd=None):
    """Activation after the encode, the hidden Linears, and the
    bottleneck dropout; returns the bottleneck ``h [B, d0]``."""
    z = activation(z, self.activation_type)
    n = len(self.hidden_layers) - 1
    for i in range(1, n + 1):
      w = getattr(self, f'encode_w_{i}')
      z = activation(linear(z, w, getattr(self, f'encode_bias_{i}'),
                                  cd), self.activation_type)
    if training and self.dropout_prob > 0:
      z = dropout(z, self.dropout_prob, generator)
    for i in range(1, n + 1):
      if self.is_constrained:
        w = getattr(self, f'encode_w_{n - i + 1}').t()
      else:
        w = getattr(self, f'decode_w_{i}')
      z = activation(linear(z, w, getattr(self, f'decode_bias_{i}'),
                                  cd), self.activation_type)
    return z

  def encode(self, input, training=False, generator=None, rows=None,
             compute_dtype=None):
    """Bottleneck ``h [B, d0]`` of a dense input.

    ``rows`` are the encoder rows the input's columns index: the whole
    table by default (the input may then be narrower than the table and
    is zero-padded to it), or gathered union rows ``[W, d0]`` for an
    input ``[B, W]``. ``generator`` drives the noise and bottleneck
    dropout when ``training``. ``compute_dtype`` overrides the model's.
    """
    cd = self._compute_dtype(compute_dtype)
    if rows is None:
      rows = self.en_embedding
    if input.shape[1] < rows.shape[0]:
      input = nn.functional.pad(input, (0, rows.shape[0] - input.shape[1]))
    z = l2_normalize_rows(input)
    if training and self.noise_prob > 0:
      z = dropout(z, self.noise_prob, generator)
    z = encode_matmul(z, rows, self.en_bias, cd)
    return self._hidden_stack(z, training, generator, cd)

  def decode_operands(self, input, input_items=None, target_items=None,
                      gathered=None, training=False, generator=None,
                      compute_dtype=None, input_users=None):
    """``(h, rows, bias)`` with scores ``h @ rows.T + bias``.

    ``input_items`` / ``target_items``: the item ids of the input's and
    the scores' columns (None: the whole catalog); ``input_users`` is not
    used (an item-based model). ``gathered``: the
    union rows of the sparse step, by :meth:`sparse_entries` name; the
    tables are then not read, except for the decoder bias.
    """
    if gathered is not None:
      en_rows = gathered['en_rows']
      rows = gathered.get('de_rows', en_rows)
    else:
      en_rows = take_rows(self.en_embedding, input_items)
      rows = take_rows(self.decoder_table(), target_items)
    h = self.encode(input, training, generator, rows=en_rows,
                    compute_dtype=compute_dtype)
    return h, rows, take_rows(self.de_bias, target_items)

  def decode(self, h, rows, bias, compute_dtype=None):
    """Scores ``h @ rows.T + bias`` of :meth:`decode_operands`' three,
    in the compute dtype (``compute_dtype`` overrides the model's)."""
    cd = self._compute_dtype(compute_dtype)
    scores = decode_matmul(h, rows, bias, cd)
    # scores travel in the compute dtype; losses re-accumulate in f32
    return scores if cd is None else scores.to(cd)

  def apply(self, input, input_items=None, target_items=None,
            training=False, generator=None, compute_dtype=None):
    """Scores of the ``target_items`` columns (all by default) for an
    input over the ``input_items`` columns, in the compute dtype."""
    return self.decode(*self.decode_operands(
        input, input_items, target_items, training=training,
        generator=generator, compute_dtype=compute_dtype), compute_dtype)

  # -- chunked full-catalog inference --------------------------------------

  def encode_coo(self, rows, cols, vals, num_rows, input_users=None,
                 compute_dtype=None):
    """The inference bottleneck ``h [num_rows, d0]`` from COO
    interactions (l2-normalize, encode, hidden stack), never densifying
    the catalog (``models/base.coo_encode``)."""
    del input_users  # an item-based model
    cd = self._compute_dtype(compute_dtype)
    z = coo_encode(self.en_embedding, rows, cols, vals, num_rows, cd)
    return self._hidden_stack(z + self.en_bias, False, None, cd)

  def decode_slice(self, h, start, width, compute_dtype=None):
    """float32 scores ``h @ E_de[start:start + width].T + b_de[...]`` of a
    contiguous catalog slice (not rounded to the compute dtype, as in
    JAX)."""
    cd = self._compute_dtype(compute_dtype)
    end = start + width
    return decode_matmul(h, self.decoder_table()[start:end],
                         self.de_bias[start:end], cd)

  def apply_gathered(self, gathered, input, input_users=None,
                     input_items=None, target_users=None, target_items=None,
                     generator=None, training=False):
    """:meth:`apply` with the table rows pre-gathered (the
    differentiable leaves of the sparse step)."""
    return self.decode(*self.decode_operands(
        input, target_items=target_items, gathered=gathered,
        training=training, generator=generator), None)

  def forward(self, input, input_users=None, input_items=None,
              target_users=None, target_items=None, generator=None,
              training=False, compute_dtype=None):
    """The :class:`FactorizationModel` contract; the user ids are
    ignored, as the JAX ``apply`` ignores them."""
    return self.apply(input, input_items, target_items, training=training,
                      generator=generator, compute_dtype=compute_dtype)
