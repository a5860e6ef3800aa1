"""Ranking metrics and the recommender evaluator (numpy only).

A copy of ``recoder_tpu/metrics.py``'s per-user metric functions, the
``Metric`` classes with their vectorized ``evaluate_batch``, and
``RecommenderEvaluator``. The evaluator iterates user batches of the
dataset directly instead of going through the JAX package's loader, and
keeps a few batches of a recommender with ``recommend_async`` in flight
on the device, as the JAX one does (without its worker thread: a
dispatch on the card does not block the caller).
"""

import collections

import numpy as np
import torch


def average_precision(x, y, k, normalize=True):
  """AP@k of ranked list ``x`` against relevant set ``y``."""
  x = np.asarray(x)[:k]
  x_in_y = np.isin(x, y, assume_unique=True).astype(int)
  tp = x_in_y.cumsum()
  precision = tp / (1 + np.arange(len(x)))
  normalization = min(k, len(y)) if normalize else len(y)
  return (precision * x_in_y).sum() / normalization


def recall(x, y, k, normalize=True):
  """Recall@k of ranked list ``x`` against relevant set ``y``."""
  x = np.asarray(x)[:k]
  x_in_y = np.isin(x, y, assume_unique=True).astype(int)
  normalization = min(k, len(y)) if normalize else len(y)
  return x_in_y.sum() / normalization


def dcg(x, y, k):
  """DCG@k (binary gains)."""
  x = np.asarray(x)[:k]
  x_in_y = np.isin(x, y, assume_unique=True).astype(int)
  return (x_in_y / np.log2(2 + np.arange(len(x)))).sum()


def ndcg(x, y, k):
  """NDCG@k = DCG@k / IDCG@k (binary gains)."""
  return dcg(x, y, k) / dcg(y, y, k)


def _hits_matrix(x_batch, y_list, k):
  """hits[b, j] = 1 iff x_batch[b, j] is relevant for user b (j < k)."""
  x_batch = np.asarray(x_batch)[:, :k]
  hits = np.zeros(x_batch.shape, dtype=np.float64)
  for b, y in enumerate(y_list):
    if len(y):
      hits[b] = np.isin(x_batch[b], y, assume_unique=True)
  return hits


def hits_from_relevant(x_batch, y_list):
  """Hits matrix via one vectorized membership test over row-offset id
  spaces; ``-1`` padding in ``x_batch`` never matches."""
  x_batch = np.asarray(x_batch)
  B, K = x_batch.shape
  lens = np.array([len(y) for y in y_list])
  if not lens.sum():
    return np.zeros((B, K), np.float64)
  rows_flat = np.repeat(np.arange(B, dtype=np.int64), lens)
  cols_flat = np.concatenate(
      [np.asarray(y) for y in y_list if len(y)]).astype(np.int64)
  stride = int(max(cols_flat.max(),
                   x_batch.max() if x_batch.size else 0)) + 1
  y_off = rows_flat * stride + cols_flat
  valid = x_batch >= 0
  x_off = (np.arange(B, dtype=np.int64)[:, None] * stride
           + np.where(valid, x_batch, 0))
  return (np.isin(x_off, y_off) & valid).astype(np.float64)


class Metric:
  """Base metric. ``evaluate(x, y)`` scores one user's ranked list
  ``x`` against their relevant items ``y``."""

  def __init__(self, metric_name):
    self.metric_name = metric_name

  def __str__(self):
    return self.metric_name

  def __hash__(self):
    return self.metric_name.__hash__()

  def __eq__(self, other):
    return str(self) == str(other)

  def evaluate(self, x, y):
    raise NotImplementedError

  def evaluate_batch(self, x_batch, y_list, hits=None):
    """Scores of a batch; the default loops over users, dropping the
    negative ids that pad ragged lists."""
    del hits
    out = []
    for x, y in zip(x_batch, y_list):
      x = np.asarray(x)
      out.append(self.evaluate(x[x >= 0], y))
    return np.array(out)


class AveragePrecision(Metric):
  """AP@k. ``normalize=True`` divides by min(k, |y|) instead of |y|."""

  def __init__(self, k, normalize=True):
    super().__init__(metric_name=f'AveragePrecision@{k}')
    self.k = k
    self.normalize = normalize

  def evaluate(self, x, y):
    return average_precision(x, y, k=self.k, normalize=self.normalize)

  def evaluate_batch(self, x_batch, y_list, hits=None):
    hits = (hits[:, :self.k] if hits is not None
            else _hits_matrix(x_batch, y_list, self.k))
    tp = hits.cumsum(axis=1)
    precision = tp / (1 + np.arange(hits.shape[1]))[None, :]
    num = (precision * hits).sum(axis=1)
    y_len = np.array([len(y) for y in y_list], dtype=np.float64)
    denom = np.minimum(self.k, y_len) if self.normalize else y_len
    with np.errstate(divide='ignore', invalid='ignore'):
      return num / denom


class Recall(Metric):
  """Recall@k. ``normalize=True`` divides by min(k, |y|)."""

  def __init__(self, k, normalize=True):
    super().__init__(metric_name=f'Recall@{k}')
    self.k = k
    self.normalize = normalize

  def evaluate(self, x, y):
    return recall(x, y, k=self.k, normalize=self.normalize)

  def evaluate_batch(self, x_batch, y_list, hits=None):
    hits = (hits[:, :self.k] if hits is not None
            else _hits_matrix(x_batch, y_list, self.k))
    y_len = np.array([len(y) for y in y_list], dtype=np.float64)
    denom = np.minimum(self.k, y_len) if self.normalize else y_len
    with np.errstate(divide='ignore', invalid='ignore'):
      return hits.sum(axis=1) / denom


class NDCG(Metric):
  """NDCG@k with binary gains."""

  def __init__(self, k):
    super().__init__(metric_name=f'NDCG@{k}')
    self.k = k

  def evaluate(self, x, y):
    return ndcg(x, y, k=self.k)

  def evaluate_batch(self, x_batch, y_list, hits=None):
    hits = (hits[:, :self.k] if hits is not None
            else _hits_matrix(x_batch, y_list, self.k))
    discounts = 1.0 / np.log2(2 + np.arange(self.k))
    dcg_k = (hits * discounts[None, :hits.shape[1]]).sum(axis=1)
    y_len = np.array([min(len(y), self.k) for y in y_list])
    cum = np.concatenate([[0.0], np.cumsum(discounts)])
    with np.errstate(divide='ignore', invalid='ignore'):
      return dcg_k / cum[y_len]


def _start_fetch(result):
  """Start bringing a ``recommend_async`` result -- a ragged list of id
  arrays, or a tensor ``[B, k]`` -- to the host; returns the function
  that waits for it and gives the lists of ids. A tensor on the card is
  copied without blocking into pinned memory, behind the work that made
  it, and the wait is for that copy alone (``Tensor.cpu()`` would wait
  for every batch dispatched after it too)."""
  if isinstance(result, (list, tuple)):
    return lambda: [np.asarray(r).tolist() for r in result]
  if not result.is_cuda:
    return result.tolist
  host = result.to('cpu', non_blocking=True)
  copied = torch.cuda.Event()
  copied.record()

  def fetch():
    copied.synchronize()
    return host.tolist()
  return fetch


class RecommenderEvaluator:
  """Evaluates a recommender over a dataset with a set of metrics.

  Args:
    recommender: anything with ``recommend(UsersInteractions)``.
    metrics (list[Metric]): metrics to compute.
  """

  def __init__(self, recommender, metrics):
    self.recommender = recommender
    self.metrics = metrics

  #: batches dispatched and not yet scored, at most, on the pipeline
  PENDING = 3

  def evaluate(self, eval_dataset, batch_size=1, num_users=None,
               num_workers=0):
    """Returns ``{metric: [per-user values]}``.

    Users whose relevant-item set is empty are skipped (every metric is
    0/0 for them), as in the JAX package. ``num_workers`` is accepted
    for the JAX package's signature and ignored, as there: the metric
    math is vectorized per batch.

    A recommender with ``recommend_async`` is pipelined as in the JAX
    package: each batch is dispatched, and its result fetched and scored
    ``PENDING`` batches later, in order, so the results are the
    synchronous ones. ``recommend_async`` may return a device tensor
    ``[B, k]`` or a ragged list of id arrays (the closed-form models').
    """
    del num_workers
    dispatch = getattr(self.recommender, 'recommend_async', None)
    depth = self.PENDING
    if dispatch is None:
      depth = 0
      dispatch = self.recommender.recommend
    results = {metric: [] for metric in self.metrics}
    processed = 0
    pending = collections.deque()
    for start in range(0, len(eval_dataset), batch_size):
      index = np.arange(start, min(start + batch_size, len(eval_dataset)))
      input, target = eval_dataset[index]
      tgt = target.interactions_matrix
      relevant = [tgt.indices[tgt.indptr[i]:tgt.indptr[i + 1]]
                  for i in range(len(target.users))]
      pending.append((_start_fetch(dispatch(input)), relevant))
      if len(pending) > depth:
        fetch, rel = pending.popleft()
        self._score(fetch(), rel, results)
      processed += len(relevant)
      if num_users is not None and processed >= num_users:
        break
    while pending:
      fetch, rel = pending.popleft()
      self._score(fetch(), rel, results)
    return results

  def _score(self, recommendations, relevant, results):
    keep = [i for i, y in enumerate(relevant) if len(y)]
    if not keep:
      return
    recommendations = [recommendations[i] for i in keep]
    relevant = [relevant[i] for i in keep]
    max_len = max((len(r) for r in recommendations), default=0)
    rect = np.full((len(recommendations), max(max_len, 1)), -1,
                   dtype=np.int64)
    for i, r in enumerate(recommendations):
      rect[i, :len(r)] = r
    shared_hits = hits_from_relevant(rect, relevant)
    for metric in self.metrics:
      results[metric].extend(
          metric.evaluate_batch(rect, relevant, hits=shared_hits).tolist())
