"""Device milliseconds a step of PyTorch's own kernels (names holding
``at::native``: elementwise, copies, reductions, the noise draw, index
kernels) in the profiled slice: the input pipeline's work that no
hand-written kernel does, as the slice's steps pay it."""

LAYER = 'input pipeline'
MOVES = 'train_batches_per_s'
PATTERN = 'at::native'


def read(run):
  if run.slice is None or not run.slice_steps:
    return None
  return (run.slice.seconds(lambda n: PATTERN in n) * 1e3
          / run.slice_steps)
