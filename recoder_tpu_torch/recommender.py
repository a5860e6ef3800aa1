"""Recommendation strategies.

Port of ``recoder_tpu/recommender.py``: :class:`Recommender`,
:class:`SimilarityRecommender` (the Aiolli'13 item-item scheme over an
embeddings index; host numpy, as in the JAX package) and
:class:`InferenceRecommender` (model-based top-k), with the top-k of the
closed-form models (iALS, EASE).
"""

import numpy as np

from recoder_tpu_torch.embedding import EmbeddingsIndex
from recoder_tpu_torch.ops.topk import top_k


def topk_unseen(model, users_interactions, num_recommendations):
  """Top-k unseen items per user from ``model.predict(...,
  return_input=True)``, in ``lax.top_k``'s order (ties to the lowest
  item id, ``ops/topk.py``): seen items score -inf, and a user with
  fewer than k unseen items gets a shorter list (the -inf tail trimmed)
  instead of watched items."""
  scores, xd = model.predict(users_interactions, return_input=True)
  scores = scores.masked_fill(xd > 0, float('-inf'))
  k = min(int(num_recommendations), model.num_items)
  vals, idx = top_k(scores, k)
  vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
  return [row[np.isfinite(v)] for row, v in zip(idx, vals)]


class Recommender:
  """Base recommender over users' interaction histories."""

  def recommend(self, users_hist):
    """Recommend a list of item ids for each user of ``users_hist``
    (a :class:`recoder_tpu_torch.data.UsersInteractions`)."""
    raise NotImplementedError


class SimilarityRecommender(Recommender):
  """Item-item similarity recommendations from an embeddings index.

  Semantics (reference recommender.py:27-101; Aiolli, RecSys'13): for
  each user, the candidate pool is the union of the ``n`` nearest
  neighbors of every history item, minus the history itself; each
  candidate is scored ``sum_h ((cos(c, h) + 1) / 2) ** scale`` over the
  user's history ``h``; the top ``num_recommendations`` by score win.

  Implementation batches all native/index work -- one threaded NN
  query and one bulk embedding fetch for the batch's distinct history
  items and candidates -- then scores each user with a small dense
  product over their own pool (|pool| x |history| x d, typically a few
  hundred rows). Total cost is O(total_history * n * d) flops and TWO
  FFI calls per batch, vs the reference's O(users * history) FFI round
  trips. (A fully-matricized [candidates x distinct-history] variant
  would do |C| * |U| * d work where the pools need a fraction of it.)
  On a brute-force index the NN query is one product on its device.

  Args:
    embeddings_index (EmbeddingsIndex): index for NN search + vectors.
    num_recommendations (int): recommendations per user (best-effort).
    n (int): neighbors fetched per history item.
    scale (float): similarity scaling exponent.
  """

  def __init__(self, embeddings_index: EmbeddingsIndex,
               num_recommendations, n=1, scale=1):
    self.embeddings_index = embeddings_index
    self.scale = scale
    self.num_recommendations = num_recommendations
    self.n = n

  def recommend(self, users_hist):
    m = users_hist.interactions_matrix.tocsr()
    num_users = len(users_hist.users)
    empty = np.array([], dtype=m.indices.dtype)
    if m.nnz == 0:
      return [empty] * num_users

    # batch the index work: distinct history items queried/fetched once
    uniq, hist_uidx = np.unique(m.indices[:m.indptr[num_users]],
                                return_inverse=True)            # [U]
    nn_lists = self.embeddings_index.get_nns_by_ids(uniq, self.n)

    # explicit integer dtype: an empty NN list would otherwise be
    # float64 and np.concatenate would promote every item id to float
    nn_lists = [np.asarray(l, dtype=np.int64) for l in nn_lists]
    flat_nns = (np.concatenate(nn_lists) if nn_lists else empty)
    cand = np.unique(flat_nns)                                   # [C]
    if len(cand) == 0:
      return [empty] * num_users
    U = len(uniq)

    # one bulk embedding fetch covering candidates and history (most
    # history items are their own near neighbors, so they reuse the
    # candidate rows; strays -- possible at small n -- fetched exactly).
    # Norms are clamped: an all-zero embedding row would otherwise
    # turn every touching user's scores into NaN
    def _unit(rows):
      norms = np.linalg.norm(rows, axis=1, keepdims=True)
      return rows / np.maximum(norms, 1e-12)

    cand_emb = _unit(
        self.embeddings_index.get_embeddings(cand).astype(np.float64))
    pos = np.searchsorted(cand, uniq)
    ok = (pos < len(cand)) & (cand[np.minimum(pos, len(cand) - 1)] == uniq)
    hist_emb = cand_emb[np.minimum(pos, len(cand) - 1)].copy()
    if not np.all(ok):
      strays = uniq[~ok]
      hist_emb[~ok] = _unit(
          self.embeddings_index.get_embeddings(strays).astype(np.float64))

    # per-item NN positions in cand (ragged, stored flat + offsets)
    nn_counts = np.fromiter((len(l) for l in nn_lists), dtype=np.int64,
                            count=U)
    nn_pos_flat = np.searchsorted(cand, flat_nns)
    nn_offsets = np.concatenate([[0], np.cumsum(nn_counts)])
    seen_pos = np.where(ok, pos, -1)  # history item's own cand position

    k = self.num_recommendations
    out = []
    for u in range(num_users):
      jpos = hist_uidx[m.indptr[u]:m.indptr[u + 1]]              # [h]
      if len(jpos) == 0:
        out.append(empty)
        continue
      # pool = union of this user's items' NNs, minus the history
      parts = [nn_pos_flat[nn_offsets[j]:nn_offsets[j + 1]] for j in jpos]
      pool = np.unique(np.concatenate(parts))
      mine = seen_pos[jpos]
      pool = pool[~np.isin(pool, mine[mine >= 0], assume_unique=False)]
      if len(pool) == 0:
        out.append(empty)
        continue
      # tiny dense product: [pool, d] @ [d, h] -> sum of scaled sims
      sims = (cand_emb[pool] @ hist_emb[jpos].T + 1.0) / 2.0
      scores = np.power(sims, self.scale).sum(axis=1)
      kk = min(k, len(scores))
      top = (np.argpartition(-scores, kk - 1)[:kk]
             if len(scores) > kk else np.arange(len(scores)))
      top = top[np.argsort(-scores[top])]
      out.append(cand[pool[top]])
    return out


class InferenceRecommender(Recommender):
  """Top-k recommendations through :meth:`Recoder.recommend`."""

  def __init__(self, model, num_recommendations):
    self.model = model
    self.num_recommendations = num_recommendations

  def recommend(self, users_hist):
    return self.model.recommend(users_hist, self.num_recommendations)

  def recommend_async(self, users_hist):
    """Dispatch on the device and return the ids' device tensor ``[B,
    k]`` (:meth:`Recoder.recommend_async`): the evaluator keeps a few
    batches in flight through it."""
    return self.model.recommend_async(users_hist, self.num_recommendations)
