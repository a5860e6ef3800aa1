"""The fused decode-loss backward's share of its roofline, in %: the
bound of one launch at the cell's shape (bf16 E0, float32 tables), over
the device time a launch of the wgmma backward (drows with dbias, the
split-K dh and its sum) in the profiled slice."""

from perfbench import roofline

LAYER = 'fused decode-loss'
MOVES = 'train_batches_per_s'
KERNELS = ('drows_dbias_bf16_wgmma_kernel', 'dh_bf16_wgmma_kernel',
           'sum_splits_bf16_kernel')
LAUNCH = 'dh_bf16_wgmma_kernel'


def read(run):
  if run.slice is None:
    return None
  launches = run.slice.launches(lambda n: LAUNCH in n)
  if not launches:
    return None
  seconds = run.slice.seconds(lambda n: any(k in n for k in KERNELS))
  W = roofline.pad_dim(run.num_items)
  d = run.reference.decode_width(run.config)
  bound_ms = roofline.decode_loss_bounds(run.batch, d, W, target_bytes=2,
                                         bf16=True)['bwd'][0]
  return 100.0 * bound_ms / (seconds * 1e3 / launches)
