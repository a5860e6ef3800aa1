"""Model-based recommendations.

Port of ``recoder_tpu/recommender.py``'s ``InferenceRecommender``. Not
ported yet: ``SimilarityRecommender`` (it needs the embeddings index and
the native ANN library).
"""


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
