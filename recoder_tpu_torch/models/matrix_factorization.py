"""Matrix factorization: user and item embedding tables and an item bias.

Port of ``recoder_tpu/models/matrix_factorization.py`` as an
``nn.Module``: ``scores = act(U[users]) @ V[items].T + b[items]``, with
dropout on the activated user factors (reference ``nn.py:283-362``).
Parameters keep the JAX names and shapes (``user_embedding``
[pad_dim(num_users), d], ``item_embedding`` [pad_dim(num_items), d],
``bias`` [pad_dim(num_items)]).

:meth:`decode_operands` gives ``(h, rows, bias)`` with ``h`` the batch's
activated and dropped-out user rows, so that the trainer's 'mse' and
'logistic' steps decode and take the loss in the fused decode-loss kernel
(``ops/fused_decode_loss.py``), as the autoencoder's do; the JAX package
computes the same function in XLA (``_forward_loss`` over
``decode_gather_matmul``).

``sparse=True`` trains both tables with row-sparse Adam: the trainer
gathers the batch's user rows and the item union's rows as leaves
(:meth:`sparse_entries`) and writes the touched rows back. The JAX
package pads a sparse table's feature axis to 128 lanes for XLA:TPU's
row scatters; the port keeps it [N, d] and ``convert.fit_table`` cuts the
pad of a JAX checkpoint.

:meth:`encode_coo` / :meth:`decode_slice` serve chunked scoring: the
activated user rows, then one contiguous slice of the catalog at a time.

``params_dtype='bfloat16'`` stores the tables and the bias in bf16, as
the autoencoder does (``compute_dtype`` then defaults to bf16).
"""

import torch

from recoder_tpu_torch.models.base import (FactorizationModel, activation,
                                           check_params_dtype,
                                           default_compute_dtype, dropout,
                                           pad_dim, xavier_uniform)
from recoder_tpu_torch.ops.gather_matmul import (as_dtype, decode_matmul,
                                                  take_rows)


class MatrixFactorization(FactorizationModel):
  """Latent-factor MF for collaborative filtering.

  Args:
    embedding_size (int): rank of the factorization.
    activation_type (str): activation applied to the user factors.
    dropout_prob (float): dropout on the activated user factors.
    sparse (bool): train the embedding tables with row-sparse Adam.
    compute_dtype (str, optional): the decode product's dtype
      ('bfloat16'); sums stay float32. A checkpoint carries it, and a
      model built without one takes the checkpoint's. Defaults to a bf16
      ``params_dtype``.
    params_dtype (str, optional): the parameters' storage dtype
      ('bfloat16'; None: float32), restored by the constructor on load
      (checkpoints store float32).
  """

  def __init__(self, embedding_size, activation_type='none',
               dropout_prob=0, sparse=False, compute_dtype=None,
               params_dtype=None):
    super().__init__()
    self.params_dtype = check_params_dtype(params_dtype)
    self.embedding_size = embedding_size
    self.activation_type = activation_type
    self.dropout_prob = dropout_prob
    self.sparse = bool(sparse)
    self.compute_dtype = as_dtype(default_compute_dtype(
        as_dtype(compute_dtype), params_dtype))
    self.num_users = None
    self.num_items = None
    self.num_users_padded = None
    self.num_items_padded = None

  def init_model(self, num_items=None, num_users=None, seed=0):
    """Create the parameters (drawn in float32 from a CPU generator
    seeded with ``seed``, stored in ``params_dtype``, on the CPU); the
    tables' fans are the logical ones."""
    self.num_items = int(num_items)
    self.num_users = int(num_users)
    self.num_items_padded = pad_dim(self.num_items)
    self.num_users_padded = pad_dim(self.num_users)
    d = self.embedding_size
    gen = torch.Generator().manual_seed(int(seed))
    return self.register_params({
        'user_embedding': xavier_uniform(
            (self.num_users_padded, d), fan_in=d, fan_out=self.num_users,
            generator=gen),
        'item_embedding': xavier_uniform(
            (self.num_items_padded, d), fan_in=d, fan_out=self.num_items,
            generator=gen),
        'bias': torch.zeros(self.num_items_padded),
    })

  def model_params(self):
    p = {
        'embedding_size': self.embedding_size,
        'activation_type': self.activation_type,
        'dropout_prob': self.dropout_prob,
    }
    if self.compute_dtype is not None:
      p['compute_dtype'] = str(self.compute_dtype).removeprefix('torch.')
    return p

  def load_model_params(self, model_params):
    self.embedding_size = model_params['embedding_size']
    self.activation_type = model_params['activation_type']
    self.dropout_prob = model_params['dropout_prob']
    # the checkpoint's compute dtype, unless the constructor chose one
    if self.compute_dtype is None and 'compute_dtype' in model_params:
      self.compute_dtype = as_dtype(model_params['compute_dtype'])

  def sparse_param_paths(self):
    return ('user_embedding', 'item_embedding') if self.sparse else ()

  def sparse_entries(self, input_users=None, input_items=None,
                     target_users=None, target_items=None):
    """Row-gather plan of the sparse step: the batch's user rows and the
    target union's item rows."""
    return [('user_rows', 'user_embedding', input_users),
            ('item_rows', 'item_embedding', target_items)]

  # -- forward -----------------------------------------------------------

  def decode_operands(self, input, input_items=None, target_items=None,
                      gathered=None, training=False, generator=None,
                      compute_dtype=None, input_users=None, keep_mask=None):
    """``(h, rows, bias)`` with scores ``h @ rows.T + bias``: ``h`` the
    activated (and, in training, dropped-out) rows of ``input_users``,
    ``rows`` and ``bias`` those of ``target_items`` (None: the whole
    catalog). ``gathered``: the sparse step's rows by
    :meth:`sparse_entries` name. The interactions (``input``) do not
    enter: MF scores depend on the user ids. ``keep_mask``: a given
    dropout mask (tests feed both frameworks the same one)."""
    del input, input_items, compute_dtype
    if gathered is not None:
      u, rows = gathered['user_rows'], gathered['item_rows']
    else:
      if input_users is None:
        raise ValueError('MatrixFactorization scores need input_users')
      u = take_rows(self.user_embedding, input_users)
      rows = take_rows(self.item_embedding, target_items)
    u = activation(u, self.activation_type)
    if training and self.dropout_prob > 0:
      u = dropout(u, self.dropout_prob, generator, keep_mask)
    return u, rows, take_rows(self.bias, target_items)

  def decode(self, h, rows, bias, compute_dtype=None):
    """Scores ``h @ rows.T + bias`` in the compute dtype."""
    cd = self.compute_dtype if compute_dtype is None else as_dtype(
        compute_dtype)
    scores = decode_matmul(h, rows, bias, cd)
    return scores if cd is None else scores.to(cd)

  def forward(self, input, input_users=None, input_items=None,
              target_users=None, target_items=None, generator=None,
              training=False, compute_dtype=None, keep_mask=None):
    """The :class:`FactorizationModel` contract (the JAX ``apply``)."""
    return self.decode(*self.decode_operands(
        input, input_items, target_items, training=training,
        generator=generator, input_users=input_users,
        keep_mask=keep_mask), compute_dtype)

  # -- chunked full-catalog inference --------------------------------------

  def encode_coo(self, rows, cols, vals, num_rows, input_users=None,
                 compute_dtype=None):
    """The inference user factors ``h [B, d]``: the activated rows of
    ``input_users``. The COO interactions are unused (MF scores depend
    on the user ids; the caller masks the seen items with them)."""
    del rows, cols, vals, num_rows, compute_dtype
    return activation(take_rows(self.user_embedding, input_users),
                      self.activation_type)

  def decode_slice(self, h, start, width, compute_dtype=None):
    """float32 scores ``h @ V[start:start + width].T + b[...]`` of a
    contiguous catalog slice."""
    cd = self.compute_dtype if compute_dtype is None else as_dtype(
        compute_dtype)
    end = start + width
    return decode_matmul(h, self.item_embedding[start:end],
                         self.bias[start:end], cd)

  def apply_gathered(self, gathered, input, input_users=None,
                     input_items=None, target_users=None, target_items=None,
                     generator=None, training=False, keep_mask=None):
    """:meth:`forward` with the table rows pre-gathered (the sparse
    step's leaves); only the bias is read from the tables."""
    return self.decode(*self.decode_operands(
        input, target_items=target_items, gathered=gathered,
        training=training, generator=generator, keep_mask=keep_mask))
