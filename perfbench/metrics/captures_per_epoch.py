"""CUDA graphs captured in the window (the change in
``Recoder.captures``) over the epochs it ran (its steps over an epoch's):
a new width signature of the 'users' epoch tables costs a warm-up and a
capture inside the epoch that meets it."""

LAYER = 'trainer'
MOVES = 'train_batches_per_s'


def read(run):
  if not run.steps:
    return None
  return run.captures / (run.steps / run.steps_per_epoch)
