"""Mega-batch negative-sampling host loader (numpy only).

The port of ``recoder_tpu/data/loader.py``'s ``Batch``, ``BatchCollator``
and ``RecommendationDataLoader``; see ``recoder_tpu_torch.utils`` for why
the port copies host-only modules instead of importing them. The same
dataset, arguments and seed yield the same batches as the JAX package's
loader, in the same order: each of the port's arrays is the valid part
of the JAX one.

Parity with reference recoder/data.py:86-251. A *mega-batch* of
``num_sampling_users`` users is fetched at once, the union of items any
of them touched becomes the compressed column space (``np.unique(...,
return_inverse=True)``), and the mega-batch is sliced into
``batch_size`` compute batches that all share that union -- so each
user's negatives are the other users' positives.

Unlike the JAX loader, a batch is not padded: the JAX package pads the
union width and nnz to bucket sizes (and estimates fixed widths) because
its compiled steps need static shapes, which the card does not; padding
would only add masked columns to the decode. Collation runs on a
background thread pool (``num_workers``) with a bounded window of
mega-batches in flight.

Random extra negatives (``num_random_negatives``): each collation draws
R item ids from ``np.random.default_rng(seed + 7)`` under a lock and
merges them into the mega's union with ``np.union1d`` (the JAX
collator's draw): at ``num_workers=0`` the batches are bitwise the JAX
loader's; with workers, which mega draws first depends on scheduling,
as in JAX.

Custom collation (``collate_fn``) takes the JAX path: each mega-batch
is passed to it whole and yielded once as ``(collate_fn(input),
collate_fn(target) or None)``.
"""


import collections
import math
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np


class Batch:
  """A sparse batch of user-item interactions, as int64 COO triplets.

  Attributes:
    users (np.ndarray int64 [num_users]): user ids.
    items (np.ndarray int64 [union] or None): the item-union ids of this
      batch's compressed column space; ``None`` means the full catalog.
    rows (np.ndarray int64 [nnz]): COO row index per interaction.
    cols (np.ndarray int64 [nnz]): COO column index in the compressed
      (or full) column space.
    vals (np.ndarray float32 [nnz]): interaction values.
  """

  def __init__(self, users, items, rows, cols, vals):
    self.users = users
    self.items = items
    self.rows = rows
    self.cols = cols
    self.vals = vals


class BatchCollator:
  """Collates :class:`UsersInteractions` into :class:`Batch` es.

  Args:
    batch_size (int): users per compute batch.
    negative_sampling (bool): compress columns to the mega-batch item
      union (mini-batch based negative sampling).
    num_items (int, optional): the catalog the random negatives are drawn
      from; defaults to the collated matrix's width.
    num_random_negatives (int): uniform-random item ids added to each
      mega's union (zero-valued columns).
    seed (int): the random negatives are drawn from
      ``default_rng(seed + 7)``.
  """

  def __init__(self, batch_size, negative_sampling=False, num_items=None,
               num_random_negatives=0, seed=0):
    self.batch_size = batch_size
    self.negative_sampling = negative_sampling
    self.num_items = num_items
    self.num_random_negatives = int(num_random_negatives)
    self._neg_rng = np.random.default_rng(seed + 7)
    # numpy Generators are not thread-safe and collation runs on workers
    self._neg_lock = threading.Lock()

  def collate(self, users_interactions):
    """Collate one mega-batch into a list of :class:`Batch` (reference
    data.py:203-251: a shared union across slices, per-slice COO)."""
    matrix = users_interactions.interactions_matrix.tocsr()
    batch_users = np.asarray(users_interactions.users, dtype=np.int64)
    num_rows = matrix.shape[0]
    indptr = matrix.indptr

    if self.negative_sampling:
      # item union of the mega-batch -> compressed column space
      items, cols = np.unique(matrix.indices, return_inverse=True)
      if self.num_random_negatives:
        num_items = (self.num_items if self.num_items is not None
                     else matrix.shape[1])
        with self._neg_lock:
          rand = self._neg_rng.integers(0, num_items,
                                        self.num_random_negatives)
        merged = np.union1d(items, rand).astype(items.dtype)
        cols = np.searchsorted(merged, items)[cols]
        items = merged
      items = items.astype(np.int64)
    else:
      items, cols = None, matrix.indices
    cols = cols.astype(np.int64, copy=False)
    vals = matrix.data.astype(np.float32, copy=False)

    batches = []
    for offset in range(0, num_rows, self.batch_size):
      hi = min(offset + self.batch_size, num_rows)
      lo_ptr, hi_ptr = indptr[offset], indptr[hi]
      rows = np.repeat(np.arange(hi - offset, dtype=np.int64),
                       np.diff(indptr[offset:hi + 1]))
      batches.append(Batch(
          users=batch_users[offset:hi], items=items, rows=rows,
          cols=cols[lo_ptr:hi_ptr], vals=vals[lo_ptr:hi_ptr]))
    return batches


class RecommendationDataLoader:
  """Iterates a :class:`RecommendationDataset` in shuffled mega-batches.

  Yields ``(input_batch, target_batch_or_None)`` pairs, one per compute
  batch, like the reference loader (data.py:138-144). Collation of the
  next mega-batches runs ahead on background threads.

  Args:
    dataset (RecommendationDataset): source dataset.
    batch_size (int): users per compute batch.
    negative_sampling (bool): mini-batch based negative sampling.
    num_sampling_users (int): mega-batch size (>= batch_size); 0 means
      equal to ``batch_size``.
    num_workers (int): background collation threads (0 = synchronous).
    collate_fn (callable, optional): custom collation over
      :class:`UsersInteractions`; each mega-batch then yields one
      ``(collate_fn(input), collate_fn(target) or None)`` pair (the
      evaluator passes the identity).
    shuffle (bool): shuffle users every epoch.
    seed (int): RNG seed for shuffling (and, plus 7, for the random
      negatives).
    num_random_negatives (int): uniform-random extra negatives a mega
      (:class:`BatchCollator`).
  """

  def __init__(self, dataset, batch_size, negative_sampling=False,
               num_sampling_users=0, num_workers=0, collate_fn=None,
               shuffle=True, seed=0, num_random_negatives=0):
    self.dataset = dataset
    self.batch_size = batch_size
    self.negative_sampling = negative_sampling
    self.num_sampling_users = num_sampling_users or batch_size
    self.num_workers = num_workers
    self.shuffle = shuffle
    self._rng = np.random.default_rng(seed)

    assert self.num_sampling_users >= batch_size, \
        'num_sampling_users should be at least equal to the batch_size'

    self.num_random_negatives = int(num_random_negatives)
    self.batch_collator = BatchCollator(
        batch_size=batch_size, negative_sampling=negative_sampling,
        num_items=dataset.interactions_matrix.shape[1],
        num_random_negatives=num_random_negatives, seed=seed)
    self._collate_fn = collate_fn or self.batch_collator.collate
    self._identity_collate = collate_fn is not None

  def _mega_batches(self):
    n = len(self.dataset)
    order = self._rng.permutation(n) if self.shuffle else np.arange(n)
    for off in range(0, n, self.num_sampling_users):
      yield order[off:off + self.num_sampling_users]

  def _collate_mega(self, user_idx):
    input_inter, target_inter = self.dataset[user_idx]
    collate = self._collate_fn
    return (collate(input_inter),
            collate(target_inter) if target_inter is not None else None)

  def __iter__(self):
    if self.num_workers > 0:
      gen = self._prefetched()
    else:
      gen = (self._collate_mega(idx) for idx in self._mega_batches())

    for input_out, target_out in gen:
      if self._identity_collate:
        yield input_out, target_out
        continue
      for i, input_batch in enumerate(input_out):
        yield input_batch, (target_out[i] if target_out is not None else None)

  def _prefetched(self):
    """Collate mega-batches on a thread pool, yielding in order.

    ``num_workers`` collations run concurrently with a bounded in-flight
    window so memory stays proportional to the worker count.
    """
    megas = self._mega_batches()
    window = max(2, self.num_workers * 2)
    with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
      pending = collections.deque()
      for idx in megas:
        pending.append(pool.submit(self._collate_mega, idx))
        if len(pending) >= window:
          yield pending.popleft().result()
      while pending:
        yield pending.popleft().result()

  def __len__(self):
    # batches per mega-batch is ceil(mega/batch_size): when the mega
    # size is not a multiple of batch_size, every mega yields a short
    # tail slice (plain ceil(n/bs) would undercount those)
    n = len(self.dataset)
    S, bs = self.num_sampling_users, self.batch_size
    full, rem = divmod(n, S)
    count = full * math.ceil(S / bs)
    if rem:
      count += math.ceil(rem / bs)
    return count
