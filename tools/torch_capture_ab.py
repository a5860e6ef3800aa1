"""Time the captured full-decode cells of a checkout of the port, so that
two commits can be compared on one card in one call.

    python3 tools/torch_capture_ab.py <checkout root> [<checkout root> ...]

Each root runs in a process of its own (its kernels built from its own
sources), in the order given -- for two commits A and B, pass ``A B B
A``. In each process, on the ML-20M-shaped CSR and then the MSD-shaped
one (``recoder_tpu_torch/data/synthetic.py``): bench.py's ML-20M
default (DynamicAutoencoder[200], bf16 compute and moments, 'mse'
confidence 3), MatrixFactorization[200] and Mult-VAE[600, 200] as
``chip_smoke.py`` phases 20, 23 and 24 train them, and bench.py's MSD
default (the packed slab, logloss): one epoch at
``fused_steps_per_call='auto'`` (the warm-up and the captures), then
``EPOCHS`` timed epochs. Prints one JSON line a cell: the root, the
cell, the user-batches/s of each timed epoch, and the card's name and
power limit.
"""

import json
import os
import subprocess
import sys
import time

EPOCHS = 2


def run_cells(root):
  sys.path.insert(0, root)
  os.chdir(root)
  from recoder_tpu_torch.data import RecommendationDataset, synthetic
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import (DynamicAutoencoder,
                                        MatrixFactorization, MultVAE)
  card = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True).stdout.strip()
  bf16 = 'bfloat16'
  blocks = dict(batch_size=500, lr=1e-3, shuffle='blocks')
  ml20m = dict(blocks, weight_decay=2e-5, negative_sampling=True)
  cells = {
      'ml20m': (lambda: Recoder(
          DynamicAutoencoder([200], 'tanh', noise_prob=0.5,
                             compute_dtype=bf16),
          optimizer_type='adam', loss='mse', loss_params={'confidence': 3},
          opt_state_dtype=bf16), ml20m),
      'mf': (lambda: Recoder(
          MatrixFactorization(200, 'tanh', dropout_prob=0.2,
                              compute_dtype=bf16),
          optimizer_type='adam', loss='mse', loss_params={'confidence': 40},
          opt_state_dtype=bf16), dict(blocks, negative_sampling=True)),
      'multvae': (lambda: Recoder(
          MultVAE(600, 200, dropout_prob=0.5, anneal_cap=0.2,
                  total_anneal_steps=2000, compute_dtype=bf16),
          optimizer_type='adam', loss='logloss', opt_state_dtype=bf16),
                  dict(blocks, negative_sampling=False)),
      'msd': (lambda: Recoder(
          DynamicAutoencoder([200], 'tanh', noise_prob=0.5,
                             compute_dtype=bf16),
          optimizer_type='adam', loss='logloss', opt_state_dtype=bf16),
              dict(ml20m, slab_cache='auto', full_decode='auto')),
  }
  dataset = None
  for name, (make, kw) in cells.items():
    if dataset is None or name == 'msd':
      dataset = RecommendationDataset(
          synthetic.synthesize_msd() if name == 'msd'
          else synthetic.synthesize_ml20m())
    trainer = make()
    trainer.train(dataset, num_epochs=1, **kw)
    rates = []
    for _ in range(EPOCHS):
      trainer.train(dataset, num_epochs=trainer.current_epoch, **kw)
      rates.append(len(trainer.last_epoch_losses)
                   / trainer.last_epoch_seconds)
    print(json.dumps({'root': root, 'cell': name, 'rates': rates,
                      'dispatch': trainer.last_epoch_dispatch,
                      'card': card}), flush=True)
    del trainer


def main():
  if len(sys.argv) == 3 and sys.argv[1] == '--one':
    run_cells(os.path.abspath(sys.argv[2]))
    return
  for root in sys.argv[1:]:
    t0 = time.time()
    subprocess.run([sys.executable, os.path.abspath(__file__), '--one',
                    root], check=True)
    print(f'# {root}: {time.time() - t0:.1f} s', flush=True)


if __name__ == '__main__':
  main()
