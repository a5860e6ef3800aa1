"""MSD-big preprocessing with the PyTorch port: binarize playcounts,
filter min_uc=20 / min_sc=50, hold out 50k users (the port of
scripts/msd-big/preprocess.py: the same flags and output files)."""

# allow running from a repo checkout without installing
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), '..'))


import argparse

import torch_pipelines as pipelines


def main():
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument('--data-dir', default='data/msd-big/',
                 help='directory containing train_triplets.txt')
  p.add_argument('--out-dir', default=None)
  p.add_argument('--min-uc', type=int, default=20)
  p.add_argument('--min-sc', type=int, default=50)
  p.add_argument('--heldout-users', type=int, default=50000)
  args = p.parse_args()

  pipelines.preprocess(pipelines.read_msd(args.data_dir), args,
                       min_sc=args.min_sc)


if __name__ == '__main__':
  main()
