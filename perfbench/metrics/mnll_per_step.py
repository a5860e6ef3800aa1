"""Launches a step of the multinomial loss's forward kernel
(``mnll_fwd_kernel``: the softmax NLL's row statistics in one pass over
the scores and the target) in the profiled slice: 1.0 where every step's
loss takes the kernel pair, 0.0 where the slice runs none (the fused
decode-loss cells, or a program without the kernels)."""

LAYER = 'multinomial loss'
MOVES = 'train_batches_per_s'
KERNEL = 'mnll_fwd_kernel'


def read(run):
  if run.slice is None or not run.slice_steps:
    return None
  return run.slice.launches(lambda n: KERNEL in n) / run.slice_steps
