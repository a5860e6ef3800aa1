"""The largest device memory the process held over set-up, the window and
the profiled slice (``torch.cuda.max_memory_allocated``), in GiB: the
slab tier and the epoch tables are most of it."""

LAYER = 'input pipeline'
MOVES = 'train_batches_per_s'


def read(run):
  return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
