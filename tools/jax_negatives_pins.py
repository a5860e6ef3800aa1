"""Pins the quality row of chip_smoke.py's phase 26 from the JAX package.

The JAX package (the port's reference) trains the tests/test_model.py
fixture protocol with the paper's negative-sampling knobs: bench.py's
DynamicAutoencoder[200] (tanh, noise 0.5), logloss, Adam lr 1e-3, weight
decay 2e-5, batch 500, ``num_sampling_users=2000``,
``num_random_negatives=1000``, negative sampling, 30 epochs, float32,
seed 42; then Recall@20, Recall@50 and NDCG@100 at 100 recommendations
over the validation set. It prints one JSON line of the three means,
which chip_smoke.py's ``NEGATIVES_PINNED`` holds (atol 0.01).

Run on the CPU from the root of the repository (a few minutes):

    JAX_PLATFORMS=cpu python3 tools/jax_negatives_pins.py
"""

import json
import os
import sys
import time

import numpy as np
import pandas as pd

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

from recoder_tpu.data import RecommendationDataset  # noqa: E402
from recoder_tpu.metrics import NDCG, Recall  # noqa: E402
from recoder_tpu.model import Recoder  # noqa: E402
from recoder_tpu.models import DynamicAutoencoder  # noqa: E402
from recoder_tpu.utils import dataframe_to_csr_matrix  # noqa: E402

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'tests', 'data')
TRAIN = dict(batch_size=500, lr=1e-3, weight_decay=2e-5, num_epochs=30,
             negative_sampling=True, num_sampling_users=2000,
             num_random_negatives=1000)


def main():
  jax.config.update('jax_platforms', 'cpu')
  train_df = pd.read_csv(os.path.join(DATA_DIR, 'train.csv.gz'))
  val_df = pd.read_csv(os.path.join(DATA_DIR, 'val.csv.gz'))
  val_df = val_df[val_df.sid.isin(train_df.sid.unique())]
  train_m, item_map, user_map = dataframe_to_csr_matrix(
      train_df, 'uid', 'sid', 'watched')
  val_m, _, _ = dataframe_to_csr_matrix(
      val_df, 'uid', 'sid', 'watched', item_id_map=item_map,
      user_id_map=user_map)
  trainer = Recoder(DynamicAutoencoder([200], 'tanh', noise_prob=0.5),
                    optimizer_type='adam', loss='logloss')
  t0 = time.time()
  trainer.train(RecommendationDataset(train_m), **TRAIN)
  metrics = [Recall(k=20), Recall(k=50), NDCG(k=100)]
  results = trainer._evaluate(RecommendationDataset(val_m, train_m), 100,
                              metrics, batch_size=500)
  print(json.dumps({'jax_backend': jax.default_backend(),
                    'train_s': round(time.time() - t0, 1),
                    **{str(m): float(np.mean(v))
                       for m, v in results.items()}}))


if __name__ == '__main__':
  main()
