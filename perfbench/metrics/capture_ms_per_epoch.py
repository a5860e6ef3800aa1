"""Host milliseconds of CUDA graph warm-ups and captures an epoch, in
the profiled call: the program's ``recoder.warm_up`` and
``recoder.capture`` ranges over the call's epochs (its steps over an
epoch's, as ``captures_per_epoch``). 0 in an epoch whose width
signature already has its graphs; None where the program records no
``recoder.train`` range."""

from perfbench import spans

LAYER = 'trainer'
MOVES = 'train_batches_per_s'


def read(run):
  if run.slice is None or not run.slice_steps:
    return None
  totals = spans.slice_totals(run.slice)
  if 'recoder.train' not in totals:
    return None
  seconds = sum(totals.get(name, (0, 0.0, 0.0))[1]
                for name in ('recoder.warm_up', 'recoder.capture'))
  return seconds * 1e3 / (run.slice_steps / run.steps_per_epoch)
