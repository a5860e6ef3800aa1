"""Host milliseconds a ``train`` call spends before its steps, in the
profiled call: the self time of the program's ``recoder.prepare`` span
(the call's arguments, data source, model and optimizer checks, slab or
union preparation) and of ``recoder.epoch_start`` (each epoch's lr,
order, optimizer schedules, loop counters, noise positions and graph
set; the epoch tables' build is its own span, not counted here), over
the call's ``recoder.train`` ranges. None where the program records no
such range."""

from perfbench import spans

LAYER = 'trainer'
MOVES = 'train_batches_per_s'


def read(run):
  if run.slice is None:
    return None
  totals = spans.slice_totals(run.slice)
  calls = totals.get('recoder.train', (0,))[0]
  if not calls:
    return None
  own = sum(totals.get(name, (0, 0.0, 0.0))[2]
            for name in ('recoder.prepare', 'recoder.epoch_start'))
  return own * 1e3 / calls
