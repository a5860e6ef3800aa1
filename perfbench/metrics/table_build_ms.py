"""Host milliseconds a build of the 'users' epoch tables takes, in the
profiled call: the program's ``recoder.epoch_tables`` ranges (the
tables built on the device and placed, with the build's one host read)
over their count. None where no table was built."""

from perfbench import spans

LAYER = 'input pipeline'
MOVES = 'train_batches_per_s'


def read(run):
  if run.slice is None:
    return None
  count, seconds, _ = spans.slice_totals(run.slice).get(
      'recoder.epoch_tables', (0, 0.0, 0.0))
  return seconds * 1e3 / count if count else None
