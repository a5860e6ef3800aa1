"""The port's resident-slab batches against the JAX package's
``DeviceDataSource`` (``maybe_cache_slabs(..., request=True)`` and
``_build_fd_from_cache``) for the same injected permutation: every
step's slab rows, user ids, valid-user count and full-decode column
mask must be equal, exactly. Blocks and users mode, with a partially
filled tail block.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from recoder_tpu.data.device_pipeline import \
    DeviceDataSource as JaxDeviceDataSource
from recoder_tpu_torch.data.device_pipeline import DeviceDataSource
from recoder_tpu_torch.models.base import pad_dim

N_USERS, N_ITEMS, BATCH = 37, 50, 8  # 5 blocks; the last holds 5 users


def _matrix(values='binary', seed=0):
  rng = np.random.default_rng(seed)
  dense = (rng.random((N_USERS, N_ITEMS)) < 0.15).astype(np.float32)
  dense[3] = 0.0  # a user with no interactions
  if values == 'ratings':
    dense *= rng.integers(1, 6, size=dense.shape)
  elif values == 'fractional':
    dense *= (1.0 + rng.random(dense.shape) * 1e-3).astype(np.float32)
  return sp.csr_matrix(dense)


def _col_mask(slab, num_items):
  """model.py's full-decode loss columns: touched and inside the catalog."""
  cols = np.arange(slab.shape[1])
  return np.any(slab != 0, axis=0) & (cols < num_items)


@pytest.mark.parametrize('values', ['binary', 'ratings', 'fractional'])
@pytest.mark.parametrize('shuffle', ['blocks', 'users'])
def test_batches_match_jax(shuffle, values):
  m = _matrix(values)
  W = pad_dim(N_ITEMS)
  ours = DeviceDataSource(m, BATCH, BATCH, N_ITEMS, shuffle=shuffle,
                          device='cpu')
  theirs = JaxDeviceDataSource(m, batch_size=BATCH,
                               num_sampling_users=BATCH, num_items=N_ITEMS,
                               union_width=128, shuffle=shuffle)
  assert ours.maybe_cache_slabs(W, request=True)
  assert theirs.maybe_cache_slabs(W, request=True)
  assert ours.steps_per_epoch == theirs.steps_per_epoch
  assert (ours.d_slab.dtype == torch.bfloat16) == (values != 'fractional')

  perm = ours.epoch_permutation(3)
  for step in range(ours.steps_per_epoch):
    a = ours.build_fd_batch(perm, step)
    b = theirs._build_fd_from_cache(jnp.asarray(perm.numpy(), jnp.int32),
                                    jnp.int32(step))
    slab_a = a['slab'].float().numpy()
    slab_b = np.asarray(b['slab']).astype(np.float32)
    np.testing.assert_array_equal(slab_a, slab_b)
    np.testing.assert_array_equal(a['users'].numpy(), np.asarray(b['users']))
    assert a['num_users'] == float(b['num_users'])
    np.testing.assert_array_equal(_col_mask(slab_a, N_ITEMS),
                                  _col_mask(slab_b, N_ITEMS))


@pytest.mark.parametrize('shuffle', ['blocks', 'users'])
def test_epoch_covers_every_user_once(shuffle):
  """The tail block is pinned last, so the epoch's steps visit every
  real user exactly once."""
  src = DeviceDataSource(_matrix(), BATCH, BATCH, N_ITEMS, shuffle=shuffle,
                         device='cpu')
  src.maybe_cache_slabs(pad_dim(N_ITEMS), request=True)
  for seed in range(4):
    perm = src.epoch_permutation(seed)
    if shuffle == 'blocks':
      assert int(perm[-1]) == src.n_blocks - 1
    seen = np.concatenate([
        src.build_fd_batch(perm, s)['users'].numpy()
        for s in range(src.steps_per_epoch)])
    real = np.sort(seen[seen < N_USERS])
    np.testing.assert_array_equal(real, np.arange(N_USERS))


def test_slab_request_recorded_on_reuse():
  src = DeviceDataSource(_matrix(), BATCH, BATCH, N_ITEMS, device='cpu')
  W = pad_dim(N_ITEMS)
  assert src.maybe_cache_slabs(W, request='auto')
  slab = src.d_slab
  assert src.maybe_cache_slabs(W, request=True)
  assert src.d_slab is slab and src._slab_request is True
  assert not src.maybe_cache_slabs(W, request=False)
  assert src.d_slab is None and src._slab_request is None


def test_slab_that_does_not_fit_raises(monkeypatch):
  """A slab over the budget is declined with the JAX reason (no longer
  raised): the step then scatters its triplets, to the same batch."""
  src = DeviceDataSource(_matrix('ratings'), BATCH, BATCH, N_ITEMS,
                         device='cpu')
  W = pad_dim(N_ITEMS)
  monkeypatch.setattr(src, '_memory_budget', lambda: 1024)
  assert not src.maybe_cache_slabs(W, request='auto')
  assert src.d_slab is None and 'exceeds the free-memory budget' in \
      src.decline_reason
  perm = src.epoch_permutation(1)
  scattered = src.build_fd_batch(perm, 2)
  assert src.maybe_cache_slabs(W, request=True)
  fetched = src.build_fd_batch(perm, 2)
  assert torch.equal(scattered['slab'], fetched['slab'])
  np.testing.assert_array_equal(
      scattered['col_mask'].numpy(),
      _col_mask(fetched['slab'].float().numpy(), N_ITEMS).astype(np.float32))


def test_ineligible_configurations_raise():
  """A mega that is no multiple of the batch raises; an explicitly stored
  zero declines the slab (the JAX reason), and the step's scatter keeps
  the zero's column in the loss mask."""
  m = _matrix()
  with pytest.raises(ValueError, match='multiple of batch_size'):
    DeviceDataSource(m, BATCH, BATCH + 1, N_ITEMS, device='cpu')
  assert DeviceDataSource(m, BATCH, 2 * BATCH, N_ITEMS,
                          device='cpu').slices_per_mega == 2
  zeros = m.copy()
  zeros.data[0] = 0.0  # an explicitly stored zero
  src = DeviceDataSource(zeros, BATCH, BATCH, N_ITEMS, device='cpu')
  with pytest.raises(RuntimeError):
    src.build_fd_batch(torch.arange(src.n_pad), 0)  # no width requested
  assert not src.maybe_cache_slabs(pad_dim(N_ITEMS), request=True)
  assert src.decline_reason == 'matrix stores explicit zero values'
  batch = src.build_fd_batch(torch.arange(src.n_pad), 0)
  col = zeros.indices[0]
  assert batch['slab'][0, col] == 0 and batch['col_mask'][col] == 1
