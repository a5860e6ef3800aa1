"""The share of the profiled slice in which no operation ran on the
device, in %: one minus the union of every kernel, copy and set interval
(on all streams) over the slice's wall time."""

LAYER = 'device'
MOVES = 'train_batches_per_s'


def read(run):
  if run.slice is None or run.slice.window_s <= 0:
    return None
  return 100.0 * (1.0 - run.slice.busy_s / run.slice.window_s)
