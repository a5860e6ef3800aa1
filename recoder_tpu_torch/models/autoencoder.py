"""Dynamic autoencoder, full-catalog path.

Port of ``recoder_tpu/models/autoencoder.py`` (``DynamicAutoencoder``)
as an ``nn.Module``:

  l2-normalize rows -> noise dropout -> encode (z @ E_en + b_en)
  -> activation and hidden Linears (with bottleneck dropout)
  -> decode (h @ E_de.T + b_de)

Parameters keep the JAX names and shapes (item tables padded to
``pad_dim(num_items)`` rows), so ``convert.py`` and the npz checkpoints
move them either way as they are. The trainer asks for the bottleneck
``h`` (:meth:`encode`) and hands it, the decoder table and its bias to
the fused decode-loss kernel; :meth:`forward` decodes with a plain
matmul (inference and the 'logloss' training loss).

Not ported yet: the union (gathered) path -- ``apply_gathered``,
``sparse_entries`` -- and the chunked inference pair ``encode_coo`` /
``decode_slice``; bf16 compute and bf16 parameters.
"""

import torch
from torch import nn

from recoder_tpu_torch.models.base import (FactorizationModel, activation,
                                           dropout, l2_normalize_rows,
                                           pad_dim, xavier_uniform)
from recoder_tpu_torch.ops.gather_matmul import decode_matmul, encode_matmul


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
    sparse, compute_dtype, params_dtype: accepted for the JAX
      package's signature; only the float32 dense configuration
      (False, None, None) is ported.
  """

  def __init__(self, hidden_layers=None, activation_type='tanh',
               is_constrained=False, dropout_prob=0.0, noise_prob=0.0,
               sparse=False, compute_dtype=None, params_dtype=None):
    super().__init__()
    if sparse:
      raise NotImplementedError('sparse embedding tables are not ported yet')
    for name, dt in (('compute_dtype', compute_dtype),
                     ('params_dtype', params_dtype)):
      if dt not in (None, 'float32'):
        raise NotImplementedError(f'{name}={dt!r}: only float32 is ported')
    self.hidden_layers = hidden_layers
    self.activation_type = activation_type
    self.is_constrained = is_constrained
    self.dropout_prob = dropout_prob
    self.noise_prob = noise_prob
    self.num_items = None
    self.num_items_padded = None

  # -- init / hyperparams ------------------------------------------------

  def init_model(self, num_items=None, num_users=None, seed=0):
    """Create the parameters (float32, on the CPU; the trainer moves
    the module). The draws come from a CPU generator seeded with
    ``seed``, so the init does not depend on the device."""
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

    self._parameters.clear()
    for name, value in params.items():
      self.register_parameter(name, nn.Parameter(value))
    return self.params()

  def model_params(self):
    return {
        'hidden_layers': self.hidden_layers,
        'activation_type': self.activation_type,
        'is_constrained': self.is_constrained,
        'dropout_prob': self.dropout_prob,
        'noise_prob': self.noise_prob,
    }

  def load_model_params(self, model_params):
    # a JAX checkpoint may name a 'compute_dtype'; the port computes in
    # float32 whatever the checkpoint was trained with
    self.hidden_layers = model_params['hidden_layers']
    self.activation_type = model_params['activation_type']
    self.is_constrained = model_params['is_constrained']
    self.dropout_prob = model_params['dropout_prob']
    self.noise_prob = model_params['noise_prob']

  # -- forward -----------------------------------------------------------

  def decoder_table(self):
    """The [num_items_padded, d0] table the decode multiplies by."""
    return self.en_embedding if self.is_constrained else self.de_embedding

  def _hidden_stack(self, z, training, generator):
    """Activation after the encode, the hidden Linears, and the
    bottleneck dropout; returns the bottleneck ``h [B, d0]``."""
    z = activation(z, self.activation_type)
    n = len(self.hidden_layers) - 1
    for i in range(1, n + 1):
      w = getattr(self, f'encode_w_{i}')
      z = activation(z @ w + getattr(self, f'encode_bias_{i}'),
                     self.activation_type)
    if training and self.dropout_prob > 0:
      z = dropout(z, self.dropout_prob, generator)
    for i in range(1, n + 1):
      if self.is_constrained:
        w = getattr(self, f'encode_w_{n - i + 1}').t()
      else:
        w = getattr(self, f'decode_w_{i}')
      z = activation(z @ w + getattr(self, f'decode_bias_{i}'),
                     self.activation_type)
    return z

  def encode(self, input, training=False, generator=None):
    """Bottleneck ``h [B, d0]`` of a dense ``[B, W]`` input (W may be
    the logical catalog; it is zero-padded to the table).

    ``generator`` drives the noise and bottleneck dropout when
    ``training``.
    """
    if input.shape[1] < self.num_items_padded:
      input = nn.functional.pad(
          input, (0, self.num_items_padded - input.shape[1]))
    z = l2_normalize_rows(input)
    if training and self.noise_prob > 0:
      z = dropout(z, self.noise_prob, generator)
    z = encode_matmul(z, self.en_embedding, self.en_bias)
    return self._hidden_stack(z, training, generator)

  def decode(self, h):
    """Scores ``[B, num_items_padded]`` for bottleneck ``h``."""
    return decode_matmul(h, self.decoder_table(), self.de_bias)

  def forward(self, input, training=False, generator=None):
    return self.decode(self.encode(input, training, generator))
