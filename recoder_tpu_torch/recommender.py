"""Model-based recommendations.

Port of ``recoder_tpu/recommender.py``'s ``InferenceRecommender``, and
the top-k of the closed-form models (iALS, EASE). Not ported yet:
``SimilarityRecommender`` (it needs the embeddings index and the native
ANN library).
"""

import numpy as np

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
