"""The shared body of the PyTorch port's dataset pipelines,
``scripts/{ml-20m,msd,msd-big}/torch_{preprocess,train,test}.py``.

Each of those scripts keeps its JAX twin's flags (``--device`` added to
train and test: 'cuda' by default, 'cpu' to run on the CPU) and calls
one function here. The behaviour is the JAX scripts': the same split,
the same model, trainer and schedule (checkpoints and validation every
10 epochs, the checkpoint prefix ``{loss}_ns_d_0.0_n_0.5_200``), the
same metrics and printed lines. A mesh flag runs under ``torchrun
--nproc_per_node=N``: :func:`make_mesh` joins the launch's group first.
"""

import os
import sys

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..')
if REPO not in sys.path:  # run from a repo checkout without installing
  sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402

COMMON = {'user_col': 'uid', 'item_col': 'sid', 'inter_col': 'watched'}


def read_ml20m(data_dir, min_rating):
  """ML-20M's ``ratings.csv``, the ratings above ``min_rating`` kept."""
  raw = pd.read_csv(os.path.join(data_dir, 'ratings.csv'), header=0)
  return raw[raw['rating'] > min_rating]


def read_msd(data_dir):
  """MSD's ``train_triplets.txt`` with the play counts binarized."""
  raw = pd.read_table(os.path.join(data_dir, 'train_triplets.txt'),
                      header=None, names=['userId', 'movieId', 'count'])
  raw['count'] = (raw['count'] > 0).astype(np.int8)
  return raw


def preprocess(raw, args, min_sc):
  """The strong-generalization split of ``raw`` into ``--out-dir``
  (default ``<data-dir>/pro_sg``)."""
  from recoder_tpu_torch.preprocessing import strong_generalization_split
  out_dir = args.out_dir or os.path.join(args.data_dir, 'pro_sg')
  strong_generalization_split(raw, out_dir, user_col='userId',
                              item_col='movieId',
                              n_heldout_users=args.heldout_users,
                              min_uc=args.min_uc, min_sc=min_sc)


def load_split(data_dir, heldout):
  """``(train, heldout input, heldout target)`` CSR matrices of a
  ``pro_sg`` directory; ``heldout`` is 'validation' or 'test'. The
  held-out matrices are indexed by the training items."""
  from recoder_tpu_torch.utils import dataframe_to_csr_matrix
  train_df = pd.read_csv(data_dir + 'train.csv')
  tr_df = pd.read_csv(data_dir + f'{heldout}_tr.csv')
  te_df = pd.read_csv(data_dir + f'{heldout}_te.csv')
  train_matrix, item_id_map, _ = dataframe_to_csr_matrix(train_df, **COMMON)
  tr_matrix, _, user_id_map = dataframe_to_csr_matrix(
      tr_df, item_id_map=item_id_map, **COMMON)
  te_matrix, _, _ = dataframe_to_csr_matrix(
      te_df, item_id_map=item_id_map, user_id_map=user_id_map, **COMMON)
  return train_matrix, tr_matrix, te_matrix


def make_mesh(device, model=1, data=None):
  """The ('data', 'model') mesh of a mesh flag: this process joins the
  launch's group (torchrun's environment; one process alone makes a
  group of one), and ``data=None`` takes the ranks left over."""
  from recoder_tpu_torch import parallel
  parallel.initialize(device=device)
  mesh = parallel.make_mesh(parallel.MeshConfig(data=data, model=model),
                            devices=device)
  print(f'mesh: {mesh.shape}')
  return mesh


def train(args, model, lr_milestones, mesh=None, num_sampling_users=0,
          num_random_negatives=0):
  """Train ``model`` on ``--data-dir``'s split with the JAX scripts'
  schedule, validating and checkpointing every 10 epochs into
  ``--model-dir``; an interrupt saves the state before it propagates."""
  from recoder_tpu_torch.data import RecommendationDataset
  from recoder_tpu_torch.metrics import NDCG, Recall
  from recoder_tpu_torch.model import Recoder

  train_matrix, val_tr_matrix, val_te_matrix = load_split(args.data_dir,
                                                          'validation')
  train_dataset = RecommendationDataset(train_matrix)
  val_dataset = RecommendationDataset(val_tr_matrix, val_te_matrix)

  trainer = Recoder(model=model, optimizer_type='adam', loss=args.loss,
                    user_based=False, mesh=mesh, device=args.device)
  if args.resume:
    trainer.init_from_model_file(args.resume)

  os.makedirs(args.model_dir, exist_ok=True)
  prefix = os.path.join(args.model_dir, f'{args.loss}_ns_d_0.0_n_0.5_200')

  metrics = [Recall(k=20, normalize=True), Recall(k=50, normalize=True),
             NDCG(k=100)]
  try:
    trainer.train(train_dataset=train_dataset, val_dataset=val_dataset,
                  batch_size=args.batch_size, lr=args.lr,
                  weight_decay=args.weight_decay, num_epochs=args.epochs,
                  negative_sampling=True, lr_milestones=lr_milestones,
                  num_sampling_users=num_sampling_users,
                  num_random_negatives=num_random_negatives,
                  model_checkpoint_prefix=prefix, checkpoint_freq=10,
                  eval_num_recommendations=100, metrics=metrics,
                  eval_freq=10)
  except (KeyboardInterrupt, SystemExit):
    trainer.save_state(prefix)
    raise
  return trainer


def test(args):
  """Evaluate ``--model-file`` on ``--data-dir``'s test split, by model
  inference or by ANN item-item similarity; prints each metric's mean
  and returns ``{metric: per-user values}``."""
  from recoder_tpu_torch.data import RecommendationDataset
  from recoder_tpu_torch.embedding import (AnnEmbeddingsIndex,
                                           MemCacheEmbeddingsIndex)
  from recoder_tpu_torch.metrics import NDCG, Recall, RecommenderEvaluator
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder
  from recoder_tpu_torch.recommender import (InferenceRecommender,
                                             SimilarityRecommender)

  if args.method == 'inference':
    model = DynamicAutoencoder()
    recoder = Recoder(model, device=args.device)
    recoder.init_from_model_file(args.model_file)
    recommender = InferenceRecommender(recoder, args.num_recommendations)
  else:
    index = AnnEmbeddingsIndex()
    index.load(index_file=args.index_file or args.model_file + '.index')
    recommender = SimilarityRecommender(MemCacheEmbeddingsIndex(index),
                                        args.num_recommendations,
                                        scale=1, n=50)

  _, te_tr_matrix, te_te_matrix = load_split(args.data_dir, 'test')
  dataset = RecommendationDataset(te_tr_matrix, te_te_matrix)

  metrics = [Recall(k=20), Recall(k=50), NDCG(k=100)]
  evaluator = RecommenderEvaluator(recommender, metrics)
  results = evaluator.evaluate(dataset, batch_size=args.batch_size)
  for metric in results:
    print(f'{metric}: {np.mean(results[metric])}')
  return results
