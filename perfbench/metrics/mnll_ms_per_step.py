"""Device milliseconds a step of the multinomial loss's kernels (names
holding ``mnll_``: the forward pass, its one-block combine and the
gradient's pass) in the profiled slice; nothing where the slice runs none
(a program without the kernels)."""

LAYER = 'multinomial loss'
MOVES = 'train_batches_per_s'
PATTERN = 'mnll_'


def read(run):
  if run.slice is None or not run.slice_steps:
    return None
  seconds = run.slice.seconds(lambda n: PATTERN in n)
  return seconds * 1e3 / run.slice_steps if seconds else None
