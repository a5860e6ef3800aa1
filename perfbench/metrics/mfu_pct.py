"""The window's model FLOPs over its wall time at the card's peak for the
cell's compute precision (989 TFLOP/s bf16, 495 TFLOP/s TF32 for
float32; the published dense rates at 700 W), in %. A step's FLOPs are
counted from the matrix and the sampling alone, by the configuration's
reference module (``step_flops``; for the autoencoder the encoder over
the batch's interactions and the decoder over its item union): 'blocks'
over the fixed megas of contiguous users, 'users' over a permutation
the benchmark draws itself; the mean over an epoch's steps times the
window's steps. A decode wider than the loss needs shows as a lower
share. The time is the window's on the host's clock."""

import numpy as np
import torch

from perfbench import roofline

LAYER = 'device'
MOVES = 'train_batches_per_s'


def read(run):
  if not run.steps or not run.window_s:
    return None
  n, B = run.num_users, run.batch
  n_pad = -(-n // B) * B
  if run.traffic['train']['shuffle'] == 'blocks':
    order = np.arange(n_pad)
  else:
    rng = np.random.default_rng([int(run.seed), 7])
    order = np.concatenate([rng.permutation(n), np.arange(n, n_pad)])
  flops = run.reference.step_flops(run.matrix, order, B, run.config,
                                   run.device)
  peak = roofline.PEAK_FLOPS[run.precision]
  mean = float(torch.mean(flops))
  return 100.0 * mean * run.steps / (run.window_s * peak)
