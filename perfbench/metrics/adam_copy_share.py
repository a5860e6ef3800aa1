"""The share of the dense Adam launch's parameter elements whose bf16
working copy the kernel writes, in %: the float32 weights that the
step's bf16 products read whole through the copy, leaving their bf16
gradient on it, in place of a cast each way a step (the program's counter
``ops/adam.COPY_SHARE``, set at each descriptor build; the last build's).
A program without the counter reports nothing."""

LAYER = 'dense Adam'
MOVES = 'train_batches_per_s'


def read(run):
  del run  # (a counter of the process)
  from recoder_tpu_torch.ops import adam
  share = getattr(adam, 'COPY_SHARE', {}).get('adam_bf16')
  return None if share is None else 100.0 * share
