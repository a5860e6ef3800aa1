"""Host dispatches a training step in the window: graph replays and eager
steps (``Recoder.last_epoch_dispatches`` summed over the window's calls)
over the steps they ran. 1/16 where every step replays a 16-step graph."""

LAYER = 'trainer'
MOVES = 'train_batches_per_s'


def read(run):
  return run.dispatches / run.steps if run.steps else None
