"""ML-20M preprocessing with the PyTorch port: binarize (rating > 3.5),
vae-cf strong generalization split with 10k held-out users (the port of
scripts/ml-20m/preprocess.py: the same flags and output files)."""

# allow running from a repo checkout without installing
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), '..'))


import argparse

import torch_pipelines as pipelines


def main():
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument('--data-dir', default='data/ml-20m/',
                 help='directory containing ratings.csv')
  p.add_argument('--out-dir', default=None,
                 help='output dir (default: <data-dir>/pro_sg)')
  p.add_argument('--min-rating', type=float, default=3.5)
  p.add_argument('--min-uc', type=int, default=5)
  p.add_argument('--heldout-users', type=int, default=10000)
  args = p.parse_args()

  pipelines.preprocess(pipelines.read_ml20m(args.data_dir, args.min_rating),
                       args, min_sc=0)


if __name__ == '__main__':
  main()
