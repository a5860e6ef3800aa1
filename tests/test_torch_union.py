"""The port's item-union batches against the JAX package's
``DeviceDataSource``, exactly: 'blocks' mode through ``build_batch`` (the
precomputed block tables) for an injected block order, 'users' mode
through ``epoch_state`` + ``build_batch(state, step)`` with the epoch
order both draw from numpy. Each step's union ``items[:width_valid]``,
``width_valid``, and every interaction's row, compressed column and
value must be equal, as must the users and the valid-user count; the
JAX slots past the batch's interactions are padding and must say so.
Also: the 'users' epoch order against the JAX ``_host_epoch_perm``, the
union width the 'auto' full-decode rule reads against the JAX package's,
and the densified union input against the JAX ``_densify``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from recoder_tpu.data import RecommendationDataset as JaxDataset
from recoder_tpu.data.device_pipeline import \
    DeviceDataSource as JaxDeviceDataSource
from recoder_tpu.data.loader import RecommendationDataLoader
from recoder_tpu.model import Recoder as JaxRecoder
from recoder_tpu.models import DynamicAutoencoder as JaxDynAE
from recoder_tpu_torch.data.device_pipeline import DeviceDataSource
from recoder_tpu_torch.model import Recoder

N_USERS, N_ITEMS, BATCH = 37, 50, 8  # 5 blocks; the last holds 5 users


def _matrix(values='binary', seed=0):
  rng = np.random.default_rng(seed)
  dense = (rng.random((N_USERS, N_ITEMS)) < 0.15).astype(np.float32)
  dense[3] = 0.0  # a user with no interactions
  dense[:, 7] = 0.0  # an item nobody touched
  if values == 'ratings':
    dense *= rng.integers(1, 6, size=dense.shape)
  return sp.csr_matrix(dense)


def _jax_source(m, shuffle, seed=0):
  return JaxDeviceDataSource(m, batch_size=BATCH, num_sampling_users=BATCH,
                             num_items=N_ITEMS, union_width=128,
                             shuffle=shuffle, seed=seed)


def _assert_same_batch(ours, theirs):
  items = ours['items'].numpy()
  wv = int(theirs['width_valid'])
  assert len(items) == wv
  np.testing.assert_array_equal(items, np.asarray(theirs['items'])[:wv])
  assert np.all(np.asarray(theirs['items'])[wv:] == N_ITEMS)
  nnz = len(ours['rows'])
  rows = np.asarray(theirs['rows'])
  np.testing.assert_array_equal(ours['rows'].numpy(), rows[:nnz])
  assert np.all(rows[nnz:] == BATCH)  # padding slots drop out
  np.testing.assert_array_equal(ours['cols'].numpy(),
                                np.asarray(theirs['cols'])[:nnz])
  np.testing.assert_array_equal(ours['vals'].numpy(),
                                np.asarray(theirs['vals'])[:nnz])
  np.testing.assert_array_equal(ours['users'].numpy(),
                                np.asarray(theirs['users']))
  assert ours['num_users'] == float(theirs['num_users'])


@pytest.mark.parametrize('values', ['binary', 'ratings'])
def test_blocks_batches_match_jax(values):
  m = _matrix(values)
  ours = DeviceDataSource(m, BATCH, BATCH, N_ITEMS, shuffle='blocks',
                          device='cpu')
  theirs = _jax_source(m, 'blocks')
  assert theirs._precomputed is not None
  assert ours.steps_per_epoch == theirs.steps_per_epoch
  perm = ours.epoch_permutation(2)
  assert int(perm[-1]) == ours.n_blocks - 1  # the partial block is last
  for step in range(ours.steps_per_epoch):
    _assert_same_batch(
        ours.build_union_batch(perm, step),
        theirs.build_batch(jnp.asarray(perm.numpy(), jnp.int32),
                           jnp.int32(step), negative_sampling=True))


@pytest.mark.parametrize('values', ['binary', 'ratings'])
def test_users_batches_match_jax(values):
  m = _matrix(values, seed=1)
  ours = DeviceDataSource(m, BATCH, BATCH, N_ITEMS, shuffle='users', seed=5,
                          device='cpu')
  theirs = _jax_source(m, 'users', seed=5)
  assert theirs.users_precompute
  for epoch in (1, 2):
    state = theirs.epoch_state(epoch)
    perm = ours.epoch_permutation(epoch)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(state['perm']))
    for step in range(ours.steps_per_epoch):
      _assert_same_batch(ours.build_union_batch(perm, step),
                         theirs.build_batch(state, jnp.int32(step)))


@pytest.mark.parametrize('seed', [0, 7])
def test_users_order_matches_jax(seed):
  m = _matrix()
  ours = DeviceDataSource(m, BATCH, BATCH, N_ITEMS, shuffle='users',
                          seed=seed, device='cpu')
  theirs = _jax_source(m, 'users', seed=seed)
  for epoch in (1, 2, 3):
    np.testing.assert_array_equal(
        ours.epoch_permutation(epoch).numpy(),
        np.asarray(theirs._host_epoch_perm(epoch)))


def test_blocks_order_is_seeded():
  src = DeviceDataSource(_matrix(), BATCH, BATCH, N_ITEMS, shuffle='blocks',
                         seed=4, device='cpu')
  a, b = src.epoch_permutation(1), src.epoch_permutation(2)
  assert torch.equal(a, src.epoch_permutation(1)) and not torch.equal(a, b)
  assert sorted(a.tolist()) == list(range(src.n_blocks))


@pytest.mark.parametrize('shuffle', ['blocks', 'users'])
def test_union_width_matches_jax(shuffle):
  """The width the 'auto' full-decode rule compares the catalog with is
  the JAX trainer's: the exact largest block union ('blocks') or the
  loader's sampled estimate ('users')."""
  m = _matrix()
  ours = DeviceDataSource(m, BATCH, BATCH, N_ITEMS, shuffle=shuffle,
                          device='cpu')
  if shuffle == 'blocks':
    want = _jax_source(m, 'blocks').union_width
  else:
    want = RecommendationDataLoader(
        JaxDataset(m), batch_size=BATCH, negative_sampling=True,
        num_sampling_users=BATCH)._estimate_widths()[0]
  assert ours.union_width() == want


def test_densify_matches_jax():
  m = _matrix('ratings')
  src = DeviceDataSource(m, BATCH, BATCH, N_ITEMS, shuffle='users',
                         device='cpu')
  batch = src.build_union_batch(src.epoch_permutation(1), 1)
  W = len(batch['items'])
  got = Recoder._densify_union(batch, BATCH, W)
  jtr = JaxRecoder(JaxDynAE([4]))
  want = jtr._densify(jnp.asarray(batch['rows'].numpy()),
                      jnp.asarray(batch['cols'].numpy()),
                      jnp.asarray(batch['vals'].numpy()), BATCH, W)
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))
  np.testing.assert_array_equal(
      got.numpy(),
      m[np.minimum(batch['users'].numpy(), N_USERS - 1)].toarray()[
          :, batch['items'].numpy()] * (batch['users'].numpy()
                                        < N_USERS)[:, None])
