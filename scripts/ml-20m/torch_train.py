"""Train the ML-20M autoencoder with the PyTorch port (the port of
scripts/ml-20m/train.py; config: DynamicAutoencoder[200] tanh, noise
0.5, BCE, adam, bs 500, lr 1e-3, wd 2e-5, 100 epochs, LR milestones
[60, 80]; ``--device cpu`` trains on the CPU)."""

# allow running from a repo checkout without installing
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), '..'))


import argparse

import torch_pipelines as pipelines


def main():
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument('--data-dir', default='data/ml-20m/pro_sg/')
  p.add_argument('--model-dir', default='models/ml-20m/')
  p.add_argument('--model', choices=['autoencoder', 'mf'],
                 default='autoencoder')
  p.add_argument('--loss', default='logistic',
                 choices=['logistic', 'mse', 'logloss'])
  p.add_argument('--epochs', type=int, default=100)
  p.add_argument('--batch-size', type=int, default=500)
  p.add_argument('--lr', type=float, default=1e-3)
  p.add_argument('--weight-decay', type=float, default=2e-5)
  p.add_argument('--num-sampling-users', type=int, default=0)
  p.add_argument('--sparse', action='store_true')
  p.add_argument('--compute-dtype', default=None,
                 help="e.g. 'bfloat16' for tensor-core bf16 matmuls")
  p.add_argument('--resume', default=None,
                 help='checkpoint file to resume from')
  p.add_argument('--device', default='cuda',
                 help="where the model runs: 'cuda' (the card) or 'cpu'")
  args = p.parse_args()

  from recoder_tpu_torch.models import DynamicAutoencoder, MatrixFactorization
  if args.model == 'autoencoder':
    model = DynamicAutoencoder(hidden_layers=[200], activation_type='tanh',
                               noise_prob=0.5, sparse=args.sparse,
                               compute_dtype=args.compute_dtype)
  else:
    model = MatrixFactorization(embedding_size=200, activation_type='tanh',
                                dropout_prob=0.5, sparse=args.sparse,
                                compute_dtype=args.compute_dtype)
  return pipelines.train(args, model, lr_milestones=[60, 80],
                         num_sampling_users=args.num_sampling_users)


if __name__ == '__main__':
  main()
