"""Serving latency of the PyTorch port: p50/p95/p99 for the HTTP scoring
surface.

The port's counterpart of tools/bench_serving.py. It trains the
reference-protocol model (DynamicAutoencoder[200], tanh, noise 0.5,
logloss, Adam, batch 500) on the tests/data fixture for ``--epochs``
epochs (the receipt measures serving, not quality), saves a checkpoint,
builds the C++ ANN item index from the trained decoder embeddings, then
starts ``recoder_tpu_torch.cli.make_server`` in-process and sends
sequential single-client requests to both routes:

  /recommend          model forward + top-k on the device
  /recommend_similar  C++ RP-forest item-item similarity (host only)

One user per request, k = 100, histories taken from fixture rows.
Warm-up requests are excluded; the timed section is the request ->
response wall clock through the real HTTP stack. On a machine with one
CUDA card:

  python tools/torch_bench_serving.py [--requests 200] [--device cuda]

Prints one JSON line per route, each with the card's name and power
limit (``nvidia-smi --query-gpu=name,power.limit``).
"""

import argparse
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, '..'))


def log(*a):
  print(*a, file=sys.stderr, flush=True)


def card_name(device):
  """``"name, power limit"`` of the card, as nvidia-smi gives them."""
  if device == 'cpu':
    return 'cpu (no card)'
  return subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_route(base, route, bodies):
  """Sequential requests to ``base + route``, one a body: ``(latencies
  in ms, the recommendation lists of each answer)``."""
  lat, answers = [], []
  for body in bodies:
    req = urllib.request.Request(base + route, data=body,
                                 headers={'Content-Type':
                                          'application/json'})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as r:
      payload = json.loads(r.read())
    lat.append((time.perf_counter() - t0) * 1e3)
    answers.append(payload['recommendations'])
  return lat, answers


def percentiles(lat_ms):
  """p50 / p95 / p99 / mean of request latencies in ms."""
  lat = sorted(lat_ms)
  n = len(lat)
  return {'p50_ms': lat[n // 2], 'p95_ms': lat[int(n * 0.95)],
          'p99_ms': lat[min(int(n * 0.99), n - 1)], 'mean_ms': sum(lat) / n}


def main():
  ap = argparse.ArgumentParser(description=__doc__)
  ap.add_argument('--requests', type=int, default=200)
  ap.add_argument('--warmup', type=int, default=10)
  ap.add_argument('--k', type=int, default=100)
  ap.add_argument('--epochs', type=int, default=5)
  ap.add_argument('--device', default='cuda')
  ap.add_argument('--workdir', default=os.path.join(HERE, '..', 'build',
                                                    'bench_serving'))
  args = ap.parse_args()

  import pandas as pd

  from recoder_tpu_torch import cli
  from recoder_tpu_torch.data import RecommendationDataset
  from recoder_tpu_torch.embedding import (AnnEmbeddingsIndex,
                                           build_embeddings_index)
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder
  from recoder_tpu_torch.utils import dataframe_to_csr_matrix

  card = card_name(args.device)
  os.makedirs(args.workdir, exist_ok=True)
  train_df = pd.read_csv(os.path.join(HERE, '..', 'tests', 'data',
                                      'train.csv.gz'))
  matrix, _, _ = dataframe_to_csr_matrix(train_df, 'uid', 'sid', 'watched')

  log(f'training the fixture checkpoint ({args.epochs} epochs)...')
  model = DynamicAutoencoder(hidden_layers=[200], activation_type='tanh',
                             noise_prob=0.5)
  trainer = Recoder(model=model, optimizer_type='adam', loss='logloss',
                    device=args.device)
  trainer.train(train_dataset=RecommendationDataset(matrix), batch_size=500,
                lr=1e-3, weight_decay=2e-5, num_epochs=args.epochs,
                negative_sampling=True)
  ckpt = trainer.save_state(os.path.join(args.workdir, 'serve'))

  log('building the ANN index from the trained decoder embeddings...')
  index = build_embeddings_index(trainer, index_class=AnnEmbeddingsIndex,
                                 n_trees=10)
  idx_path = os.path.join(args.workdir, 'items.ann')
  index.build(index_file=idx_path)

  cfg = {
      'model': {'type': 'autoencoder', 'hidden_layers': [200],
                'activation_type': 'tanh', 'noise_prob': 0.5},
      'trainer': {'optimizer_type': 'adam', 'loss': 'logloss',
                  'device': args.device},
      'serve': {'ann_index': idx_path, 'num_neighbors': 20},
  }
  server = cli.make_server(cfg, ckpt, port=0)
  thread = threading.Thread(target=server.serve_forever, daemon=True)
  thread.start()
  base = f'http://127.0.0.1:{server.server_address[1]}'
  log(f'server up at {base}')

  rng = np.random.default_rng(0)
  users = rng.choice(matrix.shape[0], size=args.warmup + args.requests,
                     replace=False)
  bodies = [json.dumps({'interactions': [[int(i) for i in matrix.indices[
      matrix.indptr[u]:matrix.indptr[u + 1]]]], 'k': args.k}).encode()
            for u in users]

  try:
    for route in ('/recommend', '/recommend_similar'):
      time_route(base, route, bodies[:args.warmup])
      lat, answers = time_route(base, route, bodies[args.warmup:])
      if not all(r and len(r[0]) <= args.k for r in answers):
        raise AssertionError(f'{route}: an empty or over-long answer')
      print(json.dumps({
          'metric': f'serving_latency{route.replace("/", "_")}',
          'route': route, 'k': args.k, 'requests': len(lat),
          **percentiles(lat), 'device': args.device, 'card': card}),
          flush=True)
  finally:
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)


if __name__ == '__main__':
  main()
