"""Mult-VAE: a variational autoencoder with a multinomial likelihood.

Port of ``recoder_tpu/models/multvae.py`` (Liang et al., WWW'18) as an
``nn.Module``:

  l2-normalize rows -> input dropout -> gathered encode (z @ E_en[items]
  + b_en) -> tanh -> mu / logvar heads -> z = mu + exp(logvar / 2) * eps
  (training) or mu (evaluation) -> decode hidden -> tanh -> gathered
  output layer (h @ E_de[items].T + b_de[items])

Trained with ``Recoder(loss='logloss')``: the trainer's summed
multinomial NLL over the valid users is the paper's data term, and the
model adds the KL term through the trainer's aux-loss hook: with
``training=True`` :meth:`forward` returns ``(scores, aux)``, ``aux`` the
per-user KL(q(z|x) || N(0, I)) times the annealed weight
``beta = min(anneal_cap, step / total_anneal_steps)``. The trainer passes
the global step as a device tensor, so that a captured step anneals as an
eager one does.

Parameters keep the JAX names and shapes. The hidden products multiply
in the compute dtype (``models/base.linear``) and the item-table products
go through ``ops/gather_matmul`` as the autoencoder's do. 'logloss' has
no fused kernel here or in the JAX package, so Mult-VAE defines no
``decode_operands``: it trains through :meth:`forward` and the trainer's
loss, and with ``sparse=True`` through :meth:`apply_gathered` and
row-sparse Adam on its two item tables.

``forward`` takes an optional ``keep_mask`` and ``eps`` so that tests
feed both frameworks the same draws. :meth:`encode_coo` /
:meth:`decode_slice` serve chunked scoring: the decoder's hidden state
from a COO batch (at ``z = mu``), then one catalog slice at a time.
"""

import torch
from torch import nn

from recoder_tpu_torch.models.base import (FactorizationModel, activation,
                                           coo_encode, dropout,
                                           l2_normalize_rows, linear,
                                           pad_dim, xavier_uniform)
from recoder_tpu_torch.ops.gather_matmul import (as_dtype, decode_matmul,
                                                  encode_matmul, take_rows)


class MultVAE(FactorizationModel):
  """Variational autoencoder with a multinomial likelihood (Mult-VAE).

  Args:
    hidden_dim (int): width of the encoder and decoder hidden layer.
    latent_dim (int): width of the latent z.
    activation_type (str): hidden activation ('tanh' in the paper).
    dropout_prob (float): input dropout rate.
    anneal_cap (float): the final KL weight beta.
    total_anneal_steps (int): ``beta = min(anneal_cap, step /
      total_anneal_steps)``; 0: constant ``anneal_cap``.
    sparse (bool): train the two item tables with row-sparse Adam.
    compute_dtype (str, optional): the products' dtype ('bfloat16').
  """

  #: trainer hook: ``forward(..., training=True, step=...)`` returns
  #: ``(scores, aux [B])``; the trainer adds ``sum(aux * row_mask)``
  has_aux = True

  def __init__(self, hidden_dim=600, latent_dim=200,
               activation_type='tanh', dropout_prob=0.5,
               anneal_cap=0.2, total_anneal_steps=200000,
               sparse=False, compute_dtype=None):
    super().__init__()
    self.hidden_dim = int(hidden_dim)
    self.latent_dim = int(latent_dim)
    self.activation_type = activation_type
    self.dropout_prob = dropout_prob
    self.anneal_cap = float(anneal_cap)
    self.total_anneal_steps = int(total_anneal_steps)
    self.sparse = bool(sparse)
    self.compute_dtype = as_dtype(compute_dtype)
    self.num_items = None
    self.num_items_padded = None

  # -- init / hyperparams ------------------------------------------------

  def init_model(self, num_items=None, num_users=None, seed=0):
    """Create the parameters (float32, on the CPU) from a CPU generator
    seeded with ``seed``, with the JAX fans (the item tables' logical)."""
    self.num_items = int(num_items)
    self.num_items_padded = pad_dim(self.num_items)
    h, d, n = self.hidden_dim, self.latent_dim, self.num_items
    gen = torch.Generator().manual_seed(int(seed))

    def xavier(shape, fan_in, fan_out):
      return xavier_uniform(shape, fan_in, fan_out, generator=gen)

    return self.register_params({
        'en_embedding': xavier((self.num_items_padded, h), h, n),
        'en_bias': torch.zeros(h),
        'w_mu': xavier((h, d), h, d),
        'mu_bias': torch.zeros(d),
        'w_logvar': xavier((h, d), h, d),
        'logvar_bias': torch.zeros(d),
        'w_dec': xavier((d, h), d, h),
        'dec_bias': torch.zeros(h),
        'de_embedding': xavier((self.num_items_padded, h), h, n),
        'de_bias': torch.zeros(self.num_items_padded),
    })

  def model_params(self):
    p = {
        'hidden_dim': self.hidden_dim,
        'latent_dim': self.latent_dim,
        'activation_type': self.activation_type,
        'dropout_prob': self.dropout_prob,
        'anneal_cap': self.anneal_cap,
        'total_anneal_steps': self.total_anneal_steps,
    }
    if self.compute_dtype is not None:
      p['compute_dtype'] = str(self.compute_dtype).removeprefix('torch.')
    return p

  def load_model_params(self, model_params):
    self.hidden_dim = int(model_params['hidden_dim'])
    self.latent_dim = int(model_params['latent_dim'])
    self.activation_type = model_params['activation_type']
    self.dropout_prob = model_params['dropout_prob']
    self.anneal_cap = float(model_params['anneal_cap'])
    self.total_anneal_steps = int(model_params['total_anneal_steps'])
    # the checkpoint's compute dtype, unless the constructor chose one
    if self.compute_dtype is None and 'compute_dtype' in model_params:
      self.compute_dtype = as_dtype(model_params['compute_dtype'])

  def sparse_param_paths(self):
    return ('en_embedding', 'de_embedding') if self.sparse else ()

  def sparse_entries(self, input_users=None, input_items=None,
                     target_users=None, target_items=None):
    """Row-gather plan of the sparse step (the encoder and decoder tables
    are untied: two entries)."""
    return [('en_rows', 'en_embedding', input_items),
            ('de_rows', 'de_embedding', target_items)]

  # -- forward -----------------------------------------------------------

  def _beta(self, step):
    """The KL weight: ``min(anneal_cap, step / total_anneal_steps)`` (the
    cap is reached at ``anneal_cap * total_anneal_steps`` steps), or
    ``anneal_cap`` (a float) without a schedule or a step. ``step``: a
    0-dim tensor (in training on the card: the trainer's device
    counter, read by the device, so that a captured step anneals)."""
    if self.total_anneal_steps <= 0 or step is None:
      return self.anneal_cap
    frac = torch.as_tensor(step).float() / self.total_anneal_steps
    return torch.clamp(frac, max=self.anneal_cap)

  def _forward_core(self, input, en_rows, de_rows, de_bias, training,
                    generator, cd, step, keep_mask, eps):
    z = l2_normalize_rows(input)
    if training and self.dropout_prob > 0:
      z = dropout(z, self.dropout_prob, generator, keep_mask)
    z = activation(encode_matmul(z, en_rows, self.en_bias, cd),
                   self.activation_type)
    mu = linear(z, self.w_mu, self.mu_bias, cd)
    logvar = linear(z, self.w_logvar, self.logvar_bias, cd)
    if training:
      if eps is None:
        eps = torch.randn(mu.shape, generator=generator, device=mu.device)
      zlat = mu + torch.exp(0.5 * logvar) * eps
    else:
      zlat = mu  # the paper's deterministic evaluation: E[q(z|x)]
    h = activation(linear(zlat, self.w_dec, self.dec_bias, cd),
                   self.activation_type)
    scores = decode_matmul(h, de_rows, de_bias, cd)
    if cd is not None:
      scores = scores.to(cd)
    if not training:
      return scores
    kl = -0.5 * torch.sum(1.0 + logvar - mu * mu - torch.exp(logvar), dim=1)
    return scores, self._beta(step) * kl

  def forward(self, input, input_users=None, input_items=None,
              target_users=None, target_items=None, generator=None,
              training=False, compute_dtype=None, step=None, keep_mask=None,
              eps=None):
    """Scores of the ``target_items`` columns (all by default) for an
    input over the ``input_items`` columns; ``(scores, aux)`` in
    training. The user ids are not used (an item-based model)."""
    cd = self.compute_dtype if compute_dtype is None else as_dtype(
        compute_dtype)
    if input_items is None and input.shape[1] < self.num_items_padded:
      input = nn.functional.pad(
          input, (0, self.num_items_padded - input.shape[1]))
    return self._forward_core(
        input, take_rows(self.en_embedding, input_items),
        take_rows(self.de_embedding, target_items),
        take_rows(self.de_bias, target_items), training, generator, cd,
        step, keep_mask, eps)

  def apply_gathered(self, gathered, input, input_users=None,
                     input_items=None, target_users=None, target_items=None,
                     generator=None, training=False, step=None,
                     keep_mask=None, eps=None):
    """:meth:`forward` with the item-table rows pre-gathered (the sparse
    step's leaves)."""
    return self._forward_core(
        input, gathered['en_rows'], gathered['de_rows'],
        take_rows(self.de_bias, target_items), training, generator,
        self.compute_dtype, step, keep_mask, eps)

  # -- chunked full-catalog inference --------------------------------------

  def encode_coo(self, rows, cols, vals, num_rows, input_users=None,
                 compute_dtype=None):
    """The decoder's hidden state ``[num_rows, hidden_dim]`` at the
    deterministic evaluation ``z = mu``, from COO interactions
    (``models/base.coo_encode``)."""
    del input_users  # an item-based model
    cd = self.compute_dtype if compute_dtype is None else as_dtype(
        compute_dtype)
    z = coo_encode(self.en_embedding, rows, cols, vals, num_rows, cd)
    z = activation(z + self.en_bias, self.activation_type)
    mu = linear(z, self.w_mu, self.mu_bias, cd)
    return activation(linear(mu, self.w_dec, self.dec_bias, cd),
                      self.activation_type)

  def decode_slice(self, h, start, width, compute_dtype=None):
    """float32 scores of the catalog slice ``[start, start + width)``."""
    cd = self.compute_dtype if compute_dtype is None else as_dtype(
        compute_dtype)
    end = start + width
    return decode_matmul(h, self.de_embedding[start:end],
                         self.de_bias[start:end], cd)
