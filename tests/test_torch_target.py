"""Training against a target matrix, the port against the JAX package.

A ``RecommendationDataset(input, target)`` trains its input against its
target through two routes, as in JAX:

* 'users' mode: the host loader. The port's ``train`` runs 5 steps from
  the JAX trainer's initial parameters; the JAX side steps
  ``_train_step`` over its own ``_device_batch_iter`` of a loader with
  the same seed (what its ``train`` runs). Both draw the same batches.
* 'blocks' mode with negative sampling: the dual CSRs of the on-device
  source. Both sides take one injected block order; the port's ``train``
  runs 5 steps, the JAX side its step math on its ``DeviceDataSource``'s
  ``build_batch`` payloads (what its fused step runs). The port's target
  side of each batch must equal the valid part of the JAX one.

Dense and sparse tables, tied and untied decoders ('mse' through the
fused decode-loss Function, 'logloss' through the decode and the loss),
noise off: each step's loss within rtol 1e-5; the parameters and
moments after 5 steps within rtol 1e-4, with the absolute floors
``tests/test_torch_sparse.py`` uses (1e-5 on the parameters, 1e-6 on
the moments). A tied sparse decoder over two unions takes one
row-sparse step a step (``fold_dual_union``), which alone matches the
JAX function within rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from recoder_tpu.data import RecommendationDataLoader as JaxLoader
from recoder_tpu.data import RecommendationDataset as JaxDataset
from recoder_tpu.data.device_pipeline import \
    DeviceDataSource as JaxDeviceDataSource
from recoder_tpu.model import Recoder as JaxRecoder
from recoder_tpu.models import DynamicAutoencoder as JaxDynAE
from recoder_tpu.optim import fold_dual_union as jax_fold_dual_union
from recoder_tpu_torch import convert
from recoder_tpu_torch.data import RecommendationDataset
from recoder_tpu_torch.data import device_pipeline
from recoder_tpu_torch.data.device_pipeline import (DeviceDataSource,
                                                    FusedPipelineUnavailable)
from recoder_tpu_torch.model import Recoder
from recoder_tpu_torch.models import DynamicAutoencoder
from recoder_tpu_torch.optim import fold_dual_union

N_USERS, N_ITEMS, BATCH, HIDDEN = 80, 120, 16, [16]
LR, WD, STEPS, SEED = 1e-2, 1e-3, 5, 3
RTOL, PARAM_RTOL, ATOL, PARAM_ATOL = 1e-5, 1e-4, 1e-6, 1e-5


def _matrices(seed=0):
  rng = np.random.default_rng(seed)
  m = (rng.random((N_USERS, N_ITEMS)) < 0.08).astype(np.float32)
  t = (rng.random((N_USERS, N_ITEMS)) < 0.04).astype(np.float32)
  t *= rng.integers(1, 4, size=t.shape)
  t[5] = 0.0  # a user without targets
  return sp.csr_matrix(m), sp.csr_matrix(t)


def _pair(loss, constrained, sparse, m):
  """A JAX trainer ready to step and a port trainer holding its
  parameters."""
  kw = dict(hidden_layers=HIDDEN, activation_type='tanh',
            is_constrained=constrained, noise_prob=0.0, sparse=sparse)
  jtr = JaxRecoder(JaxDynAE(**kw), optimizer_type='adam', loss=loss,
                   seed=SEED)
  jtr.num_items, jtr.num_users = N_ITEMS, N_USERS
  jtr._init_training(JaxDataset(m), weight_decay=WD)
  ptr = Recoder(DynamicAutoencoder(**kw), optimizer_type='adam', loss=loss,
                seed=SEED, device='cpu')
  ptr.num_items, ptr.num_users = N_ITEMS, N_USERS
  ptr._init_model()
  with torch.no_grad():
    for name, p in ptr.model.params().items():
      p.copy_(torch.from_numpy(convert.fit_table(
          name, tuple(p.shape), np.asarray(jtr.model.params[name]))))
  return jtr, ptr


def _close(got, want, name, rtol=PARAM_RTOL, atol=ATOL):
  got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
  want = np.asarray(want)
  if want.ndim == 2 and want.shape[1] > got.shape[1]:
    assert not np.any(want[:, got.shape[1]:]), f'{name}: pad not zero'
    want = want[:, :got.shape[1]]
  np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)


def _assert_same_state(ptr, jtr):
  """Parameters and moments after the steps (rtol 1e-4, the floors)."""
  for name, p in ptr.model.params().items():
    _close(p, jtr.model.params[name], name, atol=PARAM_ATOL)
  assert set(ptr.sparse_states) == set(jtr.sparse_states)
  for path, st in ptr.sparse_states.items():
    # one row-sparse step a training step, also for a tied table that
    # two unions use (fold_dual_union)
    assert st['step'] == int(jtr.sparse_states[path]['step']) == STEPS
    for k in ('m', 'v'):
      _close(st[k], jtr.sparse_states[path][k], f'{path}/{k}')
  dense, _ = ptr._split_params()
  for name, p in dense.items():
    state = ptr.optimizer.state[p]
    _close(state['exp_avg'], jtr.opt_state['m'][name], f'm/{name}')
    _close(state['exp_avg_sq'], jtr.opt_state['v'][name], f'v/{name}')


CONFIGS = [('mse', False, False), ('logloss', True, False),
           ('mse', True, True), ('logloss', False, True)]


@pytest.mark.parametrize('loss,constrained,sparse', CONFIGS)
def test_host_loader_training_matches_jax(loss, constrained, sparse):
  m, t = _matrices()
  jtr, ptr = _pair(loss, constrained, sparse, m)
  ptr.train(RecommendationDataset(m, t), batch_size=BATCH, lr=LR,
            weight_decay=WD, num_epochs=1, iters_per_epoch=STEPS,
            negative_sampling=True, shuffle='users')
  assert ptr._train_iterator is not None  # the host loader served it
  loader = JaxLoader(JaxDataset(m, t), batch_size=BATCH,
                     negative_sampling=True, seed=SEED)
  want = []
  for batch, has_target in jtr._device_batch_iter(loader):
    assert has_target
    want.append(float(jtr._train_step(batch, has_target, jnp.float32(LR),
                                      sparse)))
    if len(want) == STEPS:
      break
  np.testing.assert_allclose(ptr.last_epoch_losses, want, rtol=RTOL)
  _assert_same_state(ptr, jtr)


def _jax_step_batch(b):
  """A JAX ``build_batch`` payload as its fused step stages it."""
  return {'in_users': b['users'], 'in_items': b['items'],
          'in_valid_users': b['num_users'],
          'in_valid_width': b['width_valid'],
          'in_rows': b['rows'], 'in_cols': b['cols'], 'in_vals': b['vals'],
          'tg_rows': b['tg_rows'], 'tg_cols': b['tg_cols'],
          'tg_vals': b['tg_vals'], 'tg_items': b['tg_items'],
          'tg_valid_width': b['tg_width_valid']}


def _block_order(n_blocks, seed=11):
  # the partial tail block stays last (both sources pin it there)
  return np.concatenate([np.random.default_rng(seed).permutation(
      n_blocks - 1), [n_blocks - 1]]).astype(np.int64)


@pytest.mark.parametrize('loss,constrained,sparse', CONFIGS)
def test_dual_csr_training_matches_jax(loss, constrained, sparse,
                                       monkeypatch):
  m, t = _matrices(1)
  jtr, ptr = _pair(loss, constrained, sparse, m)
  src = JaxDeviceDataSource(m, batch_size=BATCH, num_sampling_users=BATCH,
                            num_items=N_ITEMS, union_width=128,
                            shuffle='blocks', seed=SEED, target_matrix=t)
  perm = _block_order(src.n_blocks)
  monkeypatch.setattr(DeviceDataSource, 'epoch_permutation',
                      lambda self, epoch: torch.from_numpy(perm))
  ptr.train(RecommendationDataset(m, t), batch_size=BATCH, lr=LR,
            weight_decay=WD, num_epochs=1, iters_per_epoch=STEPS,
            negative_sampling=True, shuffle='blocks')
  assert ptr.fused_data_source.target_matrix is not None
  assert ptr._train_iterator is None
  params, opt, states = jtr.model.params, jtr.opt_state, jtr.sparse_states
  want = []
  for step in range(STEPS):
    b = _jax_step_batch(src.build_batch(jnp.asarray(perm, jnp.int32),
                                        jnp.int32(step),
                                        negative_sampling=True))
    if sparse:
      params, opt, states, loss_value = jtr._sparse_step_math(
          params, opt, states, b, jnp.float32(LR), None)
    else:
      params, opt, loss_value = jtr._dense_step_math(
          params, opt, b, jnp.float32(LR), None)
    want.append(float(loss_value))
  jtr.model.params, jtr.opt_state, jtr.sparse_states = params, opt, states
  np.testing.assert_allclose(ptr.last_epoch_losses, want, rtol=RTOL)
  _assert_same_state(ptr, jtr)


def test_dual_csr_batches_match_jax():
  """Each block's target side equals the valid part of the JAX one."""
  m, t = _matrices(2)
  ours = DeviceDataSource(m, BATCH, BATCH, N_ITEMS, shuffle='blocks',
                          device='cpu', target_matrix=t)
  theirs = JaxDeviceDataSource(m, batch_size=BATCH, num_sampling_users=BATCH,
                               num_items=N_ITEMS, union_width=128,
                               shuffle='blocks', target_matrix=t)
  perm = _block_order(ours.n_blocks, seed=4)
  for step in range(ours.steps_per_epoch):
    a = ours.build_union_batch(torch.from_numpy(perm), step)
    b = theirs.build_batch(jnp.asarray(perm, jnp.int32), jnp.int32(step),
                           negative_sampling=True)
    for side in ('', 'tg_'):
      wv = int(b['width_valid' if not side else 'tg_width_valid'])
      items = a[side + 'items'].numpy()
      np.testing.assert_array_equal(items, np.asarray(b[side + 'items'])[:wv])
      rows = np.asarray(b[side + 'rows'])
      nnz = len(a[side + 'rows'])
      np.testing.assert_array_equal(a[side + 'rows'].numpy(), rows[:nnz])
      assert np.all(rows[nnz:] == BATCH)
      for k in ('cols', 'vals'):
        np.testing.assert_array_equal(a[side + k].numpy(),
                                      np.asarray(b[side + k])[:nnz])


def test_dual_csr_declines_where_jax_does(monkeypatch):
  """Past the JAX block tables' byte budget (either side) the port
  raises the JAX reason; a target matrix needs 'blocks'."""
  m, t = _matrices()
  dense_t = sp.csr_matrix(np.ones((N_USERS, N_ITEMS), np.float32))
  kw = dict(batch_size=BATCH, num_sampling_users=BATCH, num_items=N_ITEMS,
            shuffle='blocks', device='cpu')
  # the input side's tables: 5 blocks x (2 x 1024 + 128) int32 = 43,520
  # bytes; the all-ones target's: 5 x (2 x 2048 + 128) x 4 = 84,480
  monkeypatch.setattr(DeviceDataSource, 'PRECOMPUTE_BYTE_BUDGET', 50000)
  DeviceDataSource(m, target_matrix=t, **kw)
  with pytest.raises(FusedPipelineUnavailable, match='target-side'):
    DeviceDataSource(m, target_matrix=dense_t, **kw)
  with pytest.raises(FusedPipelineUnavailable, match='input side'):
    DeviceDataSource(dense_t, target_matrix=t, **kw)
  with pytest.raises(ValueError, match='blocks'):
    DeviceDataSource(m, BATCH, BATCH, N_ITEMS, shuffle='users',
                     device='cpu', target_matrix=t)
  # the budgets the JAX source applies, computed as its tables would be
  src = JaxDeviceDataSource(m, batch_size=BATCH, num_sampling_users=BATCH,
                            num_items=N_ITEMS, union_width=128,
                            shuffle='blocks', target_matrix=dense_t)
  ours = DeviceDataSource(m, BATCH, BATCH, N_ITEMS, shuffle='blocks',
                          device='cpu')
  args = (ours.n_blocks, BATCH, N_USERS)
  tg = ours._block_tables_of(dense_t)
  assert device_pipeline._jax_table_bytes(tg, dense_t.indptr, *args) == (
      src.n_blocks * (2 * src._tg['M'] + src._tg['W']) * 4)
  assert device_pipeline._jax_table_bytes(
      ours._block_unions(), m.indptr, *args) == (
          src.n_blocks * (2 * src.mega_nnz_budget + src.union_width) * 4)


def test_declined_dual_csrs_train_from_the_host_loader(monkeypatch):
  """Where the source declines the target matrix (its tables past the
  byte budget), ``train`` takes the host loader, as the JAX trainer
  does: a 'blocks' run then trains bitwise as a 'users' run."""
  m, t = _matrices(2)
  monkeypatch.setattr(DeviceDataSource, 'PRECOMPUTE_BYTE_BUDGET', 1000)
  runs = []
  for shuffle in ('blocks', 'users'):
    tr = Recoder(DynamicAutoencoder(HIDDEN), optimizer_type='adam',
                 loss='mse', seed=SEED, device='cpu')
    tr.train(RecommendationDataset(m, t), batch_size=BATCH, lr=LR,
             num_epochs=1, negative_sampling=True, shuffle=shuffle)
    assert tr.fused_data_source is None
    assert tr._train_iterator is not None
    runs.append((tr.last_epoch_losses, tr.model.params()))
  assert runs[0][0] == runs[1][0]
  assert all(torch.equal(p, runs[1][1][k]) for k, p in runs[0][1].items())


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_fold_dual_union_matches_jax(seed):
  rng = np.random.default_rng(seed)
  n, d = 60, 5
  ids1 = np.sort(rng.choice(n - 1, 23, replace=False))
  ids2 = np.sort(rng.choice(n - 1, 17 + seed, replace=False))
  g1 = rng.normal(size=(len(ids1), d)).astype(np.float32)
  g2 = rng.normal(size=(len(ids2), d)).astype(np.float32)
  ids, grads = fold_dual_union(torch.from_numpy(ids1), torch.from_numpy(g1),
                               torch.from_numpy(ids2), torch.from_numpy(g2),
                               n - 1)
  jids, jgrads = jax_fold_dual_union(
      jnp.asarray(ids1, jnp.int32), jnp.asarray(g1),
      jnp.asarray(ids2, jnp.int32), jnp.asarray(g2), n - 1)
  np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
  np.testing.assert_allclose(grads.numpy(), np.asarray(jgrads), rtol=1e-6)
  # the real ids are unique, and the overlap's gradients sum in ids1's slots
  real = ids.numpy()[ids.numpy() != n - 1]
  assert len(np.unique(real)) == len(real)
  assert set(real) == set(ids1) | set(ids2)
  total = np.zeros((n, d), np.float32)
  np.add.at(total, ids.numpy(), grads.numpy())
  want = np.zeros((n, d), np.float32)
  np.add.at(want, ids1, g1)
  np.add.at(want, ids2, g2)
  np.testing.assert_allclose(total[:-1], want[:-1], rtol=1e-6, atol=1e-7)
  assert not total[-1].any()


def test_repeated_entries_train_as_their_sum():
  """A target matrix that stores an entry twice trains as the one that
  stores their sum (the JAX ``_densify`` adds them): the host loader
  reads a canonical copy of the dataset."""
  m, t = _matrices(3)
  rows = [slice(t.indptr[u], t.indptr[u + 1]) for u in range(N_USERS)]
  repeated = sp.csr_matrix(
      (np.concatenate([np.tile(t.data[r] / 2, 2) for r in rows]),
       np.concatenate([np.tile(t.indices[r], 2) for r in rows]),
       2 * t.indptr), shape=t.shape)
  assert not repeated.has_canonical_format
  runs = []
  for target in (repeated, t):
    tr = Recoder(DynamicAutoencoder(HIDDEN), optimizer_type='adam',
                 loss='mse', seed=SEED, device='cpu')
    tr.train(RecommendationDataset(m, target), batch_size=BATCH, lr=LR,
             num_epochs=1, negative_sampling=True, shuffle='users')
    runs.append((tr.last_epoch_losses, tr.model.params()))
  assert runs[0][0] == runs[1][0]
  assert all(torch.equal(p, runs[1][1][k]) for k, p in runs[0][1].items())
