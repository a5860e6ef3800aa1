"""Synthetic interaction matrices with the published shapes of ML-20M and
MSD.

A copy of ``bench.py``'s ``synthesize`` / ``synthesize_ml20m`` and their
shape constants (numpy and scipy only), so that the port's scripts build
the benchmark's data without importing ``bench.py``.
``tests/test_torch_host.py`` holds the copy bitwise equal to the
original. ML-20M after the vae_cf filter: 116,677 train users x 20,108
items, ~9.99M interactions; MSD: 571,355 users x 41,140 items, ~59 an
user. Item popularity is Zipf-like, which sets the batch item-union
statistics that drive the compute.
"""

import sys

import numpy as np

NUM_USERS = 116_677
NUM_ITEMS = 20_108
MEAN_ITEMS_PER_USER = 86
BATCH_SIZE = 500

MSD_USERS = 571_355
MSD_ITEMS = 41_140
MSD_MEAN_ITEMS_PER_USER = 59


def _log(*a):
  print(*a, file=sys.stderr, flush=True)


def synthesize(num_users, num_items, mean_items, seed=0,
               mean_factor=0.683):
  """CSR matrix with the given shape and a Zipf popularity profile.

  Per-user counts are lognormal (sigma 0.9) clipped to [5, 1000];
  ``mean_factor`` sets the lognormal's location so that the count after
  duplicate (user, item) draws collapse is ``mean_items`` a user: 0.683
  for ML-20M (9,988,862 interactions), 0.68 for MSD. Values are 1.0.
  """
  from scipy.sparse import csr_matrix
  rng = np.random.default_rng(seed)
  counts = np.clip(rng.lognormal(mean=np.log(mean_items * mean_factor),
                                 sigma=0.9, size=num_users),
                   5, 1000).astype(np.int64)
  total = int(counts.sum())
  _log(f'synthesizing {total:,} interactions for {num_users:,} users '
       f'x {num_items:,} items')
  users = np.repeat(np.arange(num_users, dtype=np.int64), counts)
  # Zipf-like item popularity: the inverse CDF of a power law
  u = rng.random(total)
  items = np.floor(num_items * u ** 2.2).astype(np.int64)
  items = np.minimum(items, num_items - 1)
  vals = np.ones(total, dtype=np.float32)
  m = csr_matrix((vals, (users, items)), shape=(num_users, num_items))
  m.sum_duplicates()
  m.data[:] = 1.0
  _log(f'matrix built: nnz={m.nnz:,}')
  return m


def synthesize_ml20m(seed=0):
  """CSR matrix with ML-20M's shape (see :func:`synthesize`)."""
  return synthesize(NUM_USERS, NUM_ITEMS, MEAN_ITEMS_PER_USER, seed)


def synthesize_msd(seed=0):
  """CSR matrix with MSD's shape (``bench.py --dataset msd``)."""
  return synthesize(MSD_USERS, MSD_ITEMS, MSD_MEAN_ITEMS_PER_USER, seed,
                    mean_factor=0.68)
