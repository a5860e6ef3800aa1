"""Evaluation-protocol helpers: the Mult-VAE (vae_cf) protocol.

A copy of ``recoder_tpu/protocols.py`` (host code over a trainer's
``predict`` and ``evaluate``), importing the port's data and metrics.
The reference's preprocessing follows Liang et al. 2018 (vae_cf) --
strong-generalization split with per-user 80/20 fold-in (reference
scripts/ml-20m/preprocess.py:50-106) -- but ships no protocol-level
evaluation helpers. This module completes the protocol:

  * ranking metrics on the fold-out (Recall@k normalized by
    min(k, |heldout|), truncated binary NDCG@k) -- the exact
    definitions recoder_tpu_torch.metrics implements;
  * the held-out multinomial negative log-likelihood that the Mult-VAE
    paper uses for model selection (log-softmax of the full-catalog
    scores, summed over the fold-out items).
"""

import numpy as np

from recoder_tpu_torch.data import UsersInteractions
from recoder_tpu_torch.metrics import NDCG, Recall


def heldout_multinomial_nll(trainer, eval_dataset, batch_size=500,
                            num_users=None):
  """Per-user held-out multinomial NLL (Mult-VAE model-selection score).

  For each user: fold-in interactions (``eval_dataset.interactions_matrix``)
  are the model input; the NLL is ``-sum_{i in fold-out}
  log_softmax(scores)[i]`` over the full catalog, normalized by the
  fold-out count (so users with more held-out items are comparable).

  Returns np.ndarray of per-user normalized NLLs (users with empty
  fold-out are skipped, matching RecommenderEvaluator).
  """
  input_m = eval_dataset.interactions_matrix.tocsr()
  target_m = eval_dataset.target_interactions_matrix
  if target_m is None:
    raise ValueError('eval dataset needs a fold-out target')
  target_m = target_m.tocsr()

  n = input_m.shape[0] if num_users is None else min(num_users,
                                                     input_m.shape[0])
  out = []
  for lo in range(0, n, batch_size):
    hi = min(lo + batch_size, n)
    ui = UsersInteractions(users=np.arange(lo, hi),
                           interactions_matrix=input_m[lo:hi])
    scores = np.asarray(trainer.predict(ui))[:, :trainer.num_items]
    # stable log-softmax over the catalog
    scores = scores - scores.max(axis=1, keepdims=True)
    log_z = np.log(np.exp(scores).sum(axis=1))
    for r, u in enumerate(range(lo, hi)):
      held = target_m.indices[target_m.indptr[u]:target_m.indptr[u + 1]]
      if len(held) == 0:
        continue
      out.append(float(log_z[r] * len(held) - scores[r, held].sum())
                 / len(held))
  return np.asarray(out)


def evaluate_vae_protocol(trainer, eval_dataset, recall_ks=(20, 50),
                          ndcg_ks=(100,), batch_size=500, num_users=None,
                          include_nll=True):
  """Run the full Mult-VAE evaluation protocol; returns {name: mean}.

  ``eval_dataset`` carries the fold-in as its interactions matrix and
  the fold-out as its target matrix (the orientation
  ``RecommendationDataset(val_tr, val_te)`` produces).
  """
  metrics = ([Recall(k=k, normalize=True) for k in recall_ks]
             + [NDCG(k=k) for k in ndcg_ks])
  k_max = max(list(recall_ks) + list(ndcg_ks))
  results = trainer.evaluate(eval_dataset, num_recommendations=k_max,
                             metrics=metrics, batch_size=batch_size,
                             num_users=num_users)
  summary = {str(m): float(np.mean(v)) for m, v in results.items()}
  if include_nll:
    nll = heldout_multinomial_nll(trainer, eval_dataset,
                                  batch_size=batch_size,
                                  num_users=num_users)
    summary['HeldoutMultinomialNLL'] = float(np.mean(nll))
  return summary
