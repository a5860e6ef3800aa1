"""The bf16-moment Adam kernel's share of its roofline, in %: 20 bytes a
parameter (float32 parameter read and written, gradient read, bf16 m and
v read and written) over the model's parameters at the cell's shape (as
the configuration's reference module counts them), at the HBM peak,
over the device time a launch of ``adam_bf16_kernel``."""

from perfbench import roofline

LAYER = 'dense Adam'
MOVES = 'train_batches_per_s'
KERNEL = 'adam_bf16_kernel'


def read(run):
  if run.slice is None:
    return None
  launches = run.slice.launches(lambda n: KERNEL in n)
  if not launches:
    return None
  seconds = run.slice.seconds(lambda n: KERNEL in n)
  params = run.reference.param_count(run.config, run.num_items)
  return 100.0 * roofline.adam_bound_ms(params) / (seconds * 1e3 / launches)
