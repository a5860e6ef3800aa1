"""The port's model contract (``FactorizationModel.forward``) through
``Recoder``, against the JAX package's ``apply`` contract.

``TutorialAutoencoder`` is ``tests/test_extension_contract.py``'s
tutorial model written to the port's documented signature VERBATIM (no
``compute_dtype``, no ``**kwargs``): it trains on the full-decode and
the union path with a custom sum-reduced loss, evaluates, and
round-trips a checkpoint. ``SparseTutorial`` trains its encoder table
row-sparse through ``apply_gathered``, step for step as the JAX
package's sparse step. ``UserBias`` adds a per-user bias, so its
scores depend on ``input_users``: the port and the JAX package give the
same loss on one batch and the same ``predict`` scores (rtol 1e-5) and
recommendations from the same numpy parameters, which holds only if the
trainer passes the batch's user ids in training and in scoring.
DynamicAutoencoder keeps its ``decode_operands`` route through the fused
decode-loss kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch import nn

from recoder_tpu.data import RecommendationDataset as JaxDataset
from recoder_tpu.model import Recoder as JaxRecoder
from recoder_tpu.models.base import FactorizationModel as JaxModel
from recoder_tpu.models.base import pad_dim as jax_pad_dim
from recoder_tpu_torch import model as model_lib
from recoder_tpu_torch.data import RecommendationDataset
from recoder_tpu_torch.data.device_pipeline import DeviceDataSource
from recoder_tpu_torch.metrics import Recall
from recoder_tpu_torch.model import Recoder
from recoder_tpu_torch.models import DynamicAutoencoder
from recoder_tpu_torch.models.base import (FactorizationModel, pad_dim,
                                           xavier_uniform)
from recoder_tpu_torch.ops.losses import Loss


class TutorialAutoencoder(FactorizationModel):
  """One encoder / decoder pair; ``forward`` has exactly the documented
  signature."""

  def __init__(self, embedding_size=16):
    super().__init__()
    self.embedding_size = embedding_size
    self.num_items = None
    self.num_users = None
    self.num_items_padded = None

  def init_model(self, num_items=None, num_users=None, seed=0):
    self.num_items = int(num_items)
    self.num_users = int(num_users) if num_users is not None else None
    self.num_items_padded = pad_dim(self.num_items)
    d, W = self.embedding_size, self.num_items_padded
    gen = torch.Generator().manual_seed(seed)
    self.enc = nn.Parameter(xavier_uniform((W, d), W, d, gen))
    self.dec = nn.Parameter(xavier_uniform((d, W), d, W, gen))
    self.dec_bias = nn.Parameter(torch.zeros(W))
    return self.params()

  def model_params(self):
    return {'embedding_size': self.embedding_size}

  def load_model_params(self, model_params):
    self.embedding_size = model_params['embedding_size']

  def forward(self, input, input_users=None, input_items=None,
              target_users=None, target_items=None, generator=None,
              training=False):
    enc = self.enc if input_items is None else self.enc[input_items]
    h = torch.tanh(input @ enc)
    dec, bias = self.dec, self.dec_bias
    if target_items is not None:
      dec, bias = dec[:, target_items], bias[target_items]
    return h @ dec + bias


class HuberLikeLoss(Loss):
  """A custom sum-reduced loss: masks must zero padding."""

  reduction = 'sum'

  def elementwise(self, input, target, row_mask=None, col_mask=None):
    e = 0.5 * torch.square(input.float() - target.float())
    if row_mask is not None:
      e = e * row_mask[:, None]
    if col_mask is not None:
      e = e * col_mask[None, :]
    return e


def _matrix(n_users=60, n_items=90, seed=3):
  rng = np.random.default_rng(seed)
  return sp.csr_matrix(
      (rng.random((n_users, n_items)) < 0.15).astype(np.float32))


@pytest.mark.parametrize('full_decode', [True, False])
def test_custom_model_trains_evaluates_checkpoints(tmp_path, full_decode):
  m = _matrix()
  train_ds, val_ds = RecommendationDataset(m), RecommendationDataset(m, m)
  tr = Recoder(TutorialAutoencoder(16), optimizer_type='adam',
               loss=HuberLikeLoss(), device='cpu')
  kw = dict(batch_size=20, lr=1e-2, negative_sampling=True,
            shuffle='users', full_decode=full_decode)
  tr.train(train_ds, num_epochs=1, **kw)
  first = np.mean(tr.last_epoch_losses)
  tr.train(train_ds, num_epochs=6, **kw)
  assert np.mean(tr.last_epoch_losses) < first
  assert (tr.fused_data_source.d_slab is not None) == full_decode

  res = tr.evaluate(val_ds, num_recommendations=10, metrics=[Recall(k=10)],
                    batch_size=20)
  mean = float(np.mean(list(res.values())[0]))
  assert np.isfinite(mean)

  path = tr.save_state(str(tmp_path / 'ext'))
  tr2 = Recoder(TutorialAutoencoder(), optimizer_type='adam',
                loss=HuberLikeLoss(), device='cpu')
  tr2.init_from_model_file(path)
  res2 = tr2.evaluate(val_ds, num_recommendations=10,
                      metrics=[Recall(k=10)], batch_size=20)
  assert float(np.mean(list(res2.values())[0])) == mean
  tr2.train(train_ds, num_epochs=8, **kw)
  assert tr2.current_epoch == 8


class UserBias(TutorialAutoencoder):
  """The tutorial model plus a per-user bias on every score."""

  def init_model(self, num_items=None, num_users=None, seed=0):
    super().init_model(num_items, num_users, seed)
    self.user_bias = nn.Parameter(torch.zeros(pad_dim(self.num_users)))
    return self.params()

  def forward(self, input, input_users=None, input_items=None,
              target_users=None, target_items=None, generator=None,
              training=False):
    out = super().forward(input, input_users, input_items, target_users,
                          target_items, generator, training)
    return out + self.user_bias[input_users][:, None]


class JaxUserBias(JaxModel):
  """The same model on the JAX package's ``apply`` contract."""

  def __init__(self):
    self.params = None

  def init_model(self, num_items=None, num_users=None, seed=0):
    self.num_items, self.num_users = int(num_items), int(num_users)
    self.num_items_padded = jax_pad_dim(self.num_items)
    W, U = self.num_items_padded, jax_pad_dim(self.num_users)
    self.params = {'enc': jnp.zeros((W, 8)), 'dec': jnp.zeros((8, W)),
                   'dec_bias': jnp.zeros((W,)), 'user_bias': jnp.zeros((U,))}
    return self.params

  def model_params(self):
    return {}

  def load_model_params(self, model_params):
    pass

  def param_axes(self):
    return {'enc': ('item', 'embed'), 'dec': ('embed', 'item'),
            'dec_bias': ('item',), 'user_bias': ('user',)}

  def apply(self, params, input, input_users=None, input_items=None,
            target_users=None, target_items=None, rng=None, training=False):
    enc = (params['enc'] if input_items is None
           else params['enc'][input_items])
    h = jnp.tanh(input @ enc)
    dec, bias = params['dec'], params['dec_bias']
    if target_items is not None:
      dec, bias = dec[:, target_items], bias[target_items]
    return h @ dec + bias + params['user_bias'][input_users][:, None]


def test_input_users_reach_the_model_as_in_jax():
  n_users, n_items, batch = 60, 90, 16
  m = _matrix(n_users, n_items, seed=7)
  rng = np.random.default_rng(0)
  W, U = pad_dim(n_items), pad_dim(n_users)
  params = {'enc': 0.3 * rng.standard_normal((W, 8)),
            'dec': 0.3 * rng.standard_normal((8, W)),
            'dec_bias': 0.1 * rng.standard_normal(W),
            'user_bias': rng.standard_normal(U)}
  params = {k: v.astype(np.float32) for k, v in params.items()}

  jtr = JaxRecoder(JaxUserBias(), optimizer_type='adam', loss='mse')
  jtr.num_items, jtr.num_users = n_items, n_users
  jtr._init_training(JaxDataset(m), weight_decay=0.0)
  jtr.model.params = {k: jnp.asarray(v) for k, v in params.items()}
  ptr = Recoder(UserBias(8), optimizer_type='adam', loss='mse', device='cpu')
  ptr.num_items, ptr.num_users = n_items, n_users
  ptr._init_training(RecommendationDataset(m), 1e-3, 0.0)
  with torch.no_grad():
    for name, p in ptr.model.params().items():
      p.copy_(torch.from_numpy(params[name]))

  # the loss of one full-decode batch, the last of a 'users' epoch (it
  # holds pad users, whose slot id is num_users)
  source = DeviceDataSource(m, batch, batch, n_items, device='cpu')
  source.maybe_cache_slabs(W, request=True)
  perm = source.epoch_permutation(1)
  b = source.build_fd_batch(perm, source.steps_per_epoch - 1)
  assert b['num_users'] < batch
  with torch.no_grad():
    got = float(ptr._forward_loss(b, training=False))
  want = float(jtr._forward_loss(jtr.model.params, {
      'in_slab': jnp.asarray(b['slab'].float().numpy()),
      'in_users': jnp.asarray(b['users'].numpy(), jnp.int32),
      'in_items': None, 'in_valid_users': jnp.float32(b['num_users']),
      'in_valid_width': jnp.int32(0), 'fd': True,
      'fd_mask_from_slab': True}, None, False))
  np.testing.assert_allclose(got, want, rtol=1e-5)
  # the user bias matters: the same batch under other user ids differs
  other = dict(b, users=torch.roll(b['users'], 1))
  with torch.no_grad():
    assert abs(float(ptr._forward_loss(other, training=False)) - got) > 1e-3

  users, _ = RecommendationDataset(m)[[5, 2, 30, 11, 59]]
  jusers, _ = JaxDataset(m)[[5, 2, 30, 11, 59]]
  np.testing.assert_allclose(ptr.predict(users), jtr.predict(jusers),
                             rtol=1e-5, atol=1e-6)
  assert ptr.recommend(users, 10) == np.asarray(
      jtr.recommend(jusers, 10)).tolist()


def test_dynamic_autoencoder_keeps_the_fused_route(monkeypatch):
  calls = []

  def counting(*args):
    calls.append(args[6])  # the loss kind
    return fused(*args)

  fused = model_lib.fused_decode_loss
  monkeypatch.setattr(model_lib, 'fused_decode_loss', counting)
  m = _matrix()
  kw = dict(batch_size=20, negative_sampling=True, num_epochs=1)
  tr = Recoder(DynamicAutoencoder([8]), optimizer_type='adam', loss='mse',
               device='cpu')
  tr.train(RecommendationDataset(m), **kw)
  assert calls == ['mse'] * 3
  # a model without decode_operands scores through forward and the loss
  tr = Recoder(TutorialAutoencoder(8), optimizer_type='adam', loss='mse',
               device='cpu')
  tr.train(RecommendationDataset(m), **kw)
  assert len(calls) == 3 and np.all(np.isfinite(tr.last_epoch_losses))


class SparseTutorial(TutorialAutoencoder):
  """The tutorial model with its encoder table trained row-sparse: no
  ``decode_operands``, so the sparse step goes through
  ``apply_gathered``."""

  def init_model(self, num_items=None, num_users=None, seed=0):
    super().init_model(num_items, num_users, seed)
    self.enc.requires_grad_(False)
    return self.params()

  def sparse_param_paths(self):
    return ('enc',)

  def sparse_entries(self, input_users=None, input_items=None,
                     target_users=None, target_items=None):
    return [('enc_rows', 'enc', input_items)]

  def apply_gathered(self, gathered, input, input_users=None,
                     input_items=None, target_users=None, target_items=None,
                     generator=None, training=False):
    h = torch.tanh(input @ gathered['enc_rows'])
    return h @ self.dec[:, target_items] + self.dec_bias[target_items]


class JaxSparseTutorial(JaxUserBias):
  """The same model on the JAX package's contract (no user bias)."""

  def init_model(self, num_items=None, num_users=None, seed=0):
    super().init_model(num_items, num_users, seed)
    del self.params['user_bias']
    return self.params

  def param_axes(self):
    return {'enc': ('item', 'embed'), 'dec': ('embed', 'item'),
            'dec_bias': ('item',)}

  def sparse_param_paths(self):
    return ('enc',)

  def sparse_entries(self, input_users=None, input_items=None,
                     target_users=None, target_items=None):
    return [('enc_rows', 'enc', input_items)]

  def apply_gathered(self, params, gathered, input, input_users=None,
                     input_items=None, target_users=None, target_items=None,
                     rng=None, training=False):
    h = jnp.tanh(input @ gathered['enc_rows'])
    return h @ params['dec'][:, target_items] + params['dec_bias'][
        target_items]


def test_sparse_tables_without_decode_operands_train_as_in_jax():
  """A contract model with a sparse table and no ``decode_operands``
  trains through ``apply_gathered`` and row-sparse Adam: two union steps
  against the JAX ``_sparse_step_math`` from the same parameters (the
  losses, the sparse table and its moments, the dense parameters; rtol
  1e-5, absolute floors of 1e-5 on parameters and 1e-7 on moments), then
  a whole epoch through ``train``."""
  n_users, n_items, batch = 60, 90, 16
  m = _matrix(n_users, n_items, seed=9)
  rng = np.random.default_rng(1)
  W = pad_dim(n_items)
  params = {'enc': 0.3 * rng.standard_normal((W, 8)),
            'dec': 0.3 * rng.standard_normal((8, W)),
            'dec_bias': 0.1 * rng.standard_normal(W)}
  params = {k: v.astype(np.float32) for k, v in params.items()}
  jtr = JaxRecoder(JaxSparseTutorial(), optimizer_type='adam', loss='mse')
  jtr.num_items, jtr.num_users = n_items, n_users
  jtr._init_training(JaxDataset(m), weight_decay=0.0)
  jtr.model.params = {k: jnp.asarray(v) for k, v in params.items()}
  jtr.sparse_states = {'enc': jtr.sparse_adam.init(jtr.model.params['enc'])}
  ptr = Recoder(SparseTutorial(8), optimizer_type='adam', loss='mse',
                device='cpu')
  ptr.num_items, ptr.num_users = n_items, n_users
  ptr._init_training(RecommendationDataset(m), 1e-2, 0.0)
  with torch.no_grad():
    for name, p in ptr.model.params().items():
      p.copy_(torch.from_numpy(params[name]))

  source = DeviceDataSource(m, batch, batch, n_items, shuffle='users',
                            device='cpu')
  perm = source.epoch_permutation(1)
  jparams, opt_state, states = (jtr.model.params, jtr.opt_state,
                                jtr.sparse_states)
  for step in range(2):
    b = source.build_union_batch(perm, step)
    items = b['items'].numpy()
    pad = np.full(128 - len(items), n_items)
    staged = {'in_rows': jnp.asarray(b['rows'].numpy(), jnp.int32),
              'in_cols': jnp.asarray(b['cols'].numpy(), jnp.int32),
              'in_vals': jnp.asarray(b['vals'].numpy()),
              'in_users': jnp.asarray(b['users'].numpy(), jnp.int32),
              'in_items': jnp.asarray(np.concatenate([items, pad]),
                                      jnp.int32),
              'in_valid_users': jnp.float32(b['num_users']),
              'in_valid_width': jnp.int32(len(items))}
    jparams, opt_state, states, jloss = jtr._sparse_step_math(
        jparams, opt_state, states, staged, jnp.float32(1e-2), None)
    got = ptr._sparse_step_math(b)
    np.testing.assert_allclose(float(got), float(jloss), rtol=1e-5)
  for name, p in ptr.model.params().items():
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[name]),
                               rtol=1e-5, atol=1e-5, err_msg=name)
  st = ptr.sparse_states['enc']
  assert st['step'] == int(states['enc']['step']) == 2
  for k in ('m', 'v'):
    np.testing.assert_allclose(st[k].numpy(), np.asarray(states['enc'][k]),
                               rtol=1e-5, atol=1e-7, err_msg=k)

  tr = Recoder(SparseTutorial(8), optimizer_type='adam', device='cpu')
  tr.train(RecommendationDataset(m), batch_size=20, negative_sampling=True,
           num_epochs=2)
  assert np.all(np.isfinite(tr.last_epoch_losses))
  assert tr.sparse_states['enc']['step'] == 6
