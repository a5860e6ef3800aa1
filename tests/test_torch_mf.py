"""MatrixFactorization in the port against the JAX package's, on the CPU,
from the same numpy parameters (``convert.load_params``; a sparse JAX
model's tables carry a zero feature pad to 128 lanes, which the port
cuts).

* ``forward`` / ``apply_gathered`` against the JAX ``apply`` /
  ``apply_gathered``, dense and sparse, float32 and bf16, in evaluation
  and in training with the same dropout mask fed to both.
* ``_forward_loss`` and its gradients (the fused decode-loss route, its
  plain twin on the CPU) against ``jax.grad`` of the JAX
  ``_forward_loss``, full decode and union, 'mse' and 'logistic'.
* Three union steps, dense and sparse (the user table's pad slots at the
  sentinel row), and a 'users'-mode epoch of three steps through
  ``train`` from the same init and the same epoch order, against the
  JAX trainer.
* Checkpoints both ways, the compute dtype restored on load.

Tolerances: float32 rtol 1e-5 with an absolute floor of 1e-5 of the
largest value (sums in another order); parameters after Adam steps an
absolute floor of 1e-5 (Adam divides by sqrt(v): an element whose
gradient float32 sums leave near zero moves by up to lr times its
relative error); bf16 scores within 2^-7 of the largest (a score rounded
to bf16 is within 2^-9 of itself).
"""

import logging
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from recoder_tpu.data import RecommendationDataset as JaxDataset
from recoder_tpu.model import Recoder as JaxRecoder
from recoder_tpu.models import MatrixFactorization as JaxMF
from recoder_tpu.models import matrix_factorization as jax_mf_module
from recoder_tpu_torch import convert
from recoder_tpu_torch.data import RecommendationDataset
from recoder_tpu_torch.data.device_pipeline import DeviceDataSource
from recoder_tpu_torch.model import Recoder
from recoder_tpu_torch.models import MatrixFactorization

N_USERS, N_ITEMS, BATCH, D = 40, 120, 16, 12
LR, WD = 1e-2, 1e-3
RTOL, PARAM_ATOL = 1e-5, 1e-5
BF = 'bfloat16'


def _matrix(seed=0):
  rng = np.random.default_rng(seed)
  return sp.csr_matrix(
      (rng.random((N_USERS, N_ITEMS)) < 0.1).astype(np.float32))


def _numpy(params):
  return {k: np.asarray(v) for k, v in params.items()}


def _models(sparse=False, cd=None, dropout_prob=0.0, seed=5):
  kw = dict(embedding_size=D, activation_type='tanh',
            dropout_prob=dropout_prob, sparse=sparse, compute_dtype=cd)
  jm = JaxMF(**kw)
  jparams = jm.init_model(N_ITEMS, N_USERS, seed=seed)
  pm = MatrixFactorization(**kw)
  pm.init_model(N_ITEMS, N_USERS)
  convert.load_params(pm, _numpy(jparams))
  return jm, jparams, pm


def _close(got, want, rtol=RTOL, floor=1e-5, err_msg=''):
  got = got.detach().float().numpy() if torch.is_tensor(got) else got
  want = np.asarray(want, np.float32)
  np.testing.assert_allclose(got, want, rtol=rtol,
                             atol=floor * np.abs(want).max(),
                             err_msg=err_msg)


def test_sparse_tables_lose_the_jax_feature_pad():
  jm, jparams, pm = _models(sparse=True)
  assert jparams['user_embedding'].shape == (256, 128)
  assert tuple(pm.user_embedding.shape) == (256, D)
  assert not pm.user_embedding.requires_grad and pm.bias.requires_grad
  np.testing.assert_array_equal(pm.item_embedding.numpy(),
                                np.asarray(jparams['item_embedding'])[:, :D])
  back = convert.to_jax_table(pm.user_embedding.detach().numpy(),
                              jparams['user_embedding'].shape)
  np.testing.assert_array_equal(back, np.asarray(jparams['user_embedding']))


def test_init_uses_the_logical_fans():
  pm = MatrixFactorization(D)
  pm.init_model(N_ITEMS, N_USERS, seed=1)
  assert tuple(pm.user_embedding.shape) == (256, D)
  limit = np.sqrt(6.0 / (D + N_USERS))
  assert pm.user_embedding.abs().max() <= limit
  assert pm.user_embedding.abs().max() > 0.9 * limit
  again = MatrixFactorization(D)
  again.init_model(N_ITEMS, N_USERS, seed=1)
  assert torch.equal(again.item_embedding, pm.item_embedding)


@pytest.mark.parametrize('cd', [None, BF])
@pytest.mark.parametrize('sparse', [False, True])
def test_forward_matches_jax(sparse, cd, monkeypatch):
  jm, jparams, pm = _models(sparse, cd, dropout_prob=0.3)
  users = np.array([3, 0, 39, 40, 17], np.int64)  # 40: the sentinel row
  items = np.array([2, 5, 77, 119, 120], np.int64)
  x = jnp.zeros((5, pm.num_items_padded))
  keep = np.random.default_rng(2).random((5, D)) < 0.7
  monkeypatch.setattr(
      jax_mf_module, 'dropout',
      lambda u, rate, rng: jnp.where(keep, u / (1 - rate), 0.0))
  floor = 1e-5 if cd is None else 2.0 ** -7
  for target in (None, items):
    kw = dict(input_users=jnp.asarray(users, jnp.int32),
              target_items=None if target is None
              else jnp.asarray(target, jnp.int32))
    pkw = dict(input_users=torch.from_numpy(users),
               target_items=None if target is None
               else torch.from_numpy(target))
    for training in (False, True):
      want = jm.apply(jparams, x, rng=jax.random.PRNGKey(0),
                      training=training, **kw)
      with torch.no_grad():
        got = pm(torch.zeros(5, pm.num_items_padded), training=training,
                 keep_mask=torch.from_numpy(keep), **pkw)
      assert got.dtype == (torch.float32 if cd is None else torch.bfloat16)
      _close(got, want, rtol=0 if cd else RTOL, floor=floor,
             err_msg=f'target {target is not None}, training {training}')


def test_apply_gathered_matches_jax():
  jm, jparams, pm = _models(sparse=True)
  users = jnp.asarray([4, 9, 40], jnp.int32)
  items = jnp.asarray([1, 8, 64, 120], jnp.int32)
  entries = jm.sparse_entries(input_users=users, target_items=items)
  jgathered = {name: jparams[path][ids] for name, path, ids in entries}
  want = jm.apply_gathered(jparams, jgathered, None, input_users=users,
                           target_items=items)
  pentries = pm.sparse_entries(
      input_users=torch.tensor([4, 9, 40]),
      target_items=torch.tensor([1, 8, 64, 120]))
  assert [(n, p) for n, p, _ in pentries] == [(n, p) for n, p, _ in entries]
  gathered = {name: pm.params()[path].index_select(0, ids)
              for name, path, ids in pentries}
  with torch.no_grad():
    got = pm.apply_gathered(gathered, None,
                            target_items=torch.tensor([1, 8, 64, 120]))
  _close(got, want)


# -- the trainer ---------------------------------------------------------------

def _pair(loss, sparse, m, cd=None):
  """A JAX trainer ready to step and a port trainer holding its
  parameters."""
  kw = dict(embedding_size=D, activation_type='tanh', dropout_prob=0.0,
            sparse=sparse, compute_dtype=cd)
  loss_params = {'confidence': 3} if loss == 'mse' else None
  jtr = JaxRecoder(JaxMF(**kw), optimizer_type='adam', loss=loss,
                   loss_params=loss_params, seed=3)
  jtr.num_items, jtr.num_users = N_ITEMS, N_USERS
  jtr._init_training(JaxDataset(m), weight_decay=WD)
  ptr = Recoder(MatrixFactorization(**kw), optimizer_type='adam', loss=loss,
                loss_params=loss_params, seed=3, device='cpu')
  ptr.num_items, ptr.num_users = N_ITEMS, N_USERS
  ptr._init_model()
  convert.load_params(ptr.model, _numpy(jtr.model.params))
  ptr._init_training(RecommendationDataset(m), LR, WD)
  return jtr, ptr


def _source(m):
  return DeviceDataSource(m, BATCH, BATCH, N_ITEMS, shuffle='users', seed=1,
                          device='cpu')


def _union_batches(m, steps):
  src = _source(m)
  perm = src.epoch_permutation(1)
  return [src.build_union_batch(perm, s % src.steps_per_epoch)
          for s in range(steps)]


def _jax_union_batch(batch, width=128):
  """The port's union batch in the JAX trainer's staged form: the union
  padded with the sentinel item to a static width."""
  items = batch['items'].numpy()
  pad = np.full(width - len(items), N_ITEMS)
  return {'in_rows': jnp.asarray(batch['rows'].numpy(), jnp.int32),
          'in_cols': jnp.asarray(batch['cols'].numpy(), jnp.int32),
          'in_vals': jnp.asarray(batch['vals'].numpy()),
          'in_users': jnp.asarray(batch['users'].numpy(), jnp.int32),
          'in_items': jnp.asarray(np.concatenate([items, pad]), jnp.int32),
          'in_valid_users': jnp.float32(batch['num_users']),
          'in_valid_width': jnp.int32(len(items))}


def _fd_batches(m, ptr):
  src = _source(m)
  src.maybe_cache_slabs(ptr.model.num_items_padded, request=True)
  perm = src.epoch_permutation(1)
  out = []
  for s in range(src.steps_per_epoch):
    b = src.build_fd_batch(perm, s)
    out.append((b, {
        'in_slab': jnp.asarray(b['slab'].float().numpy()),
        'in_users': jnp.asarray(b['users'].numpy(), jnp.int32),
        'in_items': None, 'in_valid_users': jnp.float32(b['num_users']),
        'in_valid_width': jnp.int32(0), 'fd': True,
        'fd_mask_from_slab': True}))
  return out


@pytest.mark.parametrize('path', ['full_decode', 'union'])
@pytest.mark.parametrize('loss', ['mse', 'logistic'])
def test_forward_loss_and_gradients_match_jax(loss, path, monkeypatch):
  """The loss of a batch with pad users (the last of the epoch) and its
  gradients: the port's through the fused decode-loss Function (its
  plain twin here), the JAX package's through XLA."""
  m = _matrix(seed=1)
  jtr, ptr = _pair(loss, False, m)
  calls = []
  from recoder_tpu_torch import model as model_lib
  fused = model_lib.fused_decode_loss
  monkeypatch.setattr(model_lib, 'fused_decode_loss',
                      lambda *a: calls.append(a[6]) or fused(*a))
  if path == 'full_decode':
    b, staged = _fd_batches(m, ptr)[-1]
  else:
    b = _union_batches(m, 3)[-1]
    staged = _jax_union_batch(b)
  assert b['num_users'] < BATCH
  want, grads = jax.value_and_grad(
      lambda p: jtr._forward_loss(p, staged, None, True))(jtr.model.params)
  got = ptr._forward_loss(b, training=True)
  got.backward()
  assert calls == [loss]
  np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL)
  for name, p in ptr.model.params().items():
    _close(p.grad, grads[name], floor=1e-6, err_msg=name)


@pytest.mark.parametrize('sparse', [False, True])
def test_three_union_steps_match_jax(sparse):
  """Three union steps from the same parameters and batches (the third
  with 8 pad users): losses, parameters and every moment. A sparse user
  table's pad slots step the sentinel row, whose moments stay zero."""
  m = _matrix(seed=2)
  jtr, ptr = _pair('mse', sparse, m)
  params, opt_state = jtr.model.params, jtr.opt_state
  sparse_states = getattr(jtr, 'sparse_states', None)
  for batch in _union_batches(m, 3):
    staged = _jax_union_batch(batch)
    if sparse:
      params, opt_state, sparse_states, jloss = jtr._sparse_step_math(
          params, opt_state, sparse_states, staged, jnp.float32(LR), None)
      got = ptr._sparse_step_math(batch)
    else:
      params, opt_state, jloss = jtr._dense_step_math(
          params, opt_state, staged, jnp.float32(LR), None)
      got = ptr._dense_step_math(batch)
    np.testing.assert_allclose(float(got), float(jloss), rtol=RTOL)
  for name, p in ptr.model.params().items():
    want = np.asarray(params[name])[..., :p.shape[-1]]
    np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-4,
                               atol=PARAM_ATOL, err_msg=name)
  if sparse:
    assert set(ptr.sparse_states) == {'user_embedding', 'item_embedding'}
    for path, st in ptr.sparse_states.items():
      assert st['step'] == int(sparse_states[path]['step']) == 3
      for k in ('m', 'v'):
        want = np.asarray(sparse_states[path][k])[:, :D]
        np.testing.assert_allclose(st[k].numpy(), want, rtol=1e-4,
                                   atol=1e-7, err_msg=f'{path}/{k}')
    users = ptr.sparse_states['user_embedding']
    assert not users['m'][N_USERS].any() and not users['v'][N_USERS].any()
    assert users['m'][:N_USERS].abs().sum(1).gt(0).all()


def _jax_epoch_loss(caplog):
  msgs = [r.getMessage() for r in caplog.records
          if r.name == 'recoder_tpu' and 'loss=' in r.getMessage()]
  return float(re.search(r'loss=([-0-9.]+)', msgs[-1]).group(1))


@pytest.mark.parametrize('sparse,full_decode', [(False, True),
                                                (False, False),
                                                (True, False)])
def test_users_mode_training_matches_jax_trainer(sparse, full_decode,
                                                 caplog):
  """A 'users'-mode epoch of 3 steps through ``train``, from the JAX
  trainer's initial parameters: the same epoch order (numpy, seed 3),
  so the same batches, epoch loss and final parameters."""
  caplog.set_level(logging.INFO, logger='recoder_tpu')
  m = _matrix(seed=4)
  kw = dict(embedding_size=D, activation_type='tanh', dropout_prob=0.0,
            sparse=sparse)
  common = dict(optimizer_type='adam', loss='mse',
                loss_params={'confidence': 3}, seed=3)
  jtr = JaxRecoder(JaxMF(**kw), **common)
  jtr.num_items, jtr.num_users = N_ITEMS, N_USERS
  jtr._init_model()
  ptr = Recoder(MatrixFactorization(**kw), device='cpu', **common)
  ptr.num_items, ptr.num_users = N_ITEMS, N_USERS
  ptr._init_model()
  convert.load_params(ptr.model, _numpy(jtr.model.params))
  train_kw = dict(batch_size=BATCH, lr=LR, weight_decay=WD, num_epochs=1,
                  negative_sampling=True, shuffle='users',
                  full_decode=full_decode)
  jtr.train(JaxDataset(m), **train_kw)
  ptr.train(RecommendationDataset(m), **train_kw)
  assert len(ptr.last_epoch_losses) == 3
  assert (ptr.fused_data_source.d_slab is not None) == full_decode
  np.testing.assert_allclose(np.mean(ptr.last_epoch_losses),
                             _jax_epoch_loss(caplog), rtol=1e-4)
  for name, p in ptr.model.params().items():
    want = np.asarray(jtr.model.params[name])[..., :p.shape[-1]]
    np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-4,
                               atol=PARAM_ATOL, err_msg=name)


# -- checkpoints ---------------------------------------------------------------

def _scores(trainer, m):
  users, _ = (RecommendationDataset if isinstance(trainer, Recoder)
              else JaxDataset)(m)[np.arange(N_USERS)]
  return np.asarray(trainer.predict(users))


@pytest.mark.parametrize('sparse', [False, True])
def test_checkpoints_both_ways(sparse, tmp_path):
  m = _matrix(seed=5)
  kw = dict(batch_size=BATCH, lr=LR, num_epochs=1, negative_sampling=True)
  ptr = Recoder(MatrixFactorization(D, 'tanh', sparse=sparse),
                optimizer_type='adam', loss='mse', device='cpu')
  ptr.train(RecommendationDataset(m), **kw)
  path = ptr.save_state(str(tmp_path / 'port'))
  jtr = JaxRecoder(JaxMF(1, sparse=sparse), optimizer_type='adam')
  jtr.init_from_model_file(path)
  assert jtr.model.embedding_size == D
  np.testing.assert_allclose(_scores(jtr, m), _scores(ptr, m), rtol=1e-5,
                             atol=1e-6)

  jtr.train(JaxDataset(m), num_epochs=2, **{k: v for k, v in kw.items()
                                            if k != 'num_epochs'})
  jpath = jtr.save_state(str(tmp_path / 'jax'))
  back = Recoder(MatrixFactorization(1, sparse=sparse), device='cpu')
  back.init_from_model_file(jpath)
  np.testing.assert_allclose(_scores(back, m), _scores(jtr, m), rtol=1e-5,
                             atol=1e-6)
  assert back.model.params()['user_embedding'].shape[1] == D


def test_compute_dtype_round_trips(tmp_path):
  m = _matrix(seed=6)
  ptr = Recoder(MatrixFactorization(D, compute_dtype=BF),
                optimizer_type='adam', device='cpu')
  ptr.train(RecommendationDataset(m), batch_size=BATCH, num_epochs=1,
            negative_sampling=True)
  path = ptr.save_state(str(tmp_path / 'bf'))
  for built, want in ((None, torch.bfloat16), ('float32', torch.float32)):
    tr = Recoder(MatrixFactorization(1, compute_dtype=built), device='cpu')
    tr.init_from_model_file(path)
    assert tr.model.compute_dtype == want
  jtr = JaxRecoder(JaxMF(1))
  jtr.init_from_model_file(path)
  assert jtr.model.compute_dtype == jnp.bfloat16


def test_params_dtype_other_than_float32_raises():
  """float32 and bf16 storage train; float16 constructs, as in the JAX
  package, and ``train`` refuses it with the JAX message."""
  assert MatrixFactorization(4, params_dtype='float32').compute_dtype \
      == torch.float32
  assert MatrixFactorization(4, params_dtype=BF).compute_dtype \
      == torch.bfloat16
  m = sp.csr_matrix((np.random.default_rng(0).random((20, 30)) < 0.2)
                    .astype(np.float32))
  tr = Recoder(MatrixFactorization(4, params_dtype='float16'),
               optimizer_type='adam', device='cpu')
  with pytest.raises(ValueError, match='float32 or bfloat16'):
    tr.train(RecommendationDataset(m), batch_size=8, negative_sampling=True)
