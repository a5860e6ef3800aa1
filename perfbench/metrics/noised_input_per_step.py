"""Launches a step of the encoder's one-pass input kernel
(``noised_input``: the rows L2-normalized and the noise mask applied) in
the profiled slice: 1.0 where every step's input takes it, 0.0 where the
slice runs none (a float32 input, or a program without the kernel)."""

LAYER = 'input pipeline'
MOVES = 'train_batches_per_s'
KERNEL = 'noised_input'


def read(run):
  if run.slice is None or not run.slice_steps:
    return None
  return run.slice.launches(lambda n: KERNEL in n) / run.slice_steps
