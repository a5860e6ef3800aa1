"""The fused decode-loss forward's share of its roofline, in %: the
bound of one launch at the cell's shape (bf16 operands, a bf16 target,
float32 tables: the batch, the hidden width and the padded catalog),
over the device time a launch of the wgmma forward (the operand cast,
the persistent forward and the partial sums) in the profiled slice."""

from perfbench import roofline

LAYER = 'fused decode-loss'
MOVES = 'train_batches_per_s'
KERNELS = ('cast_operands_bf16_kernel', 'decode_loss_fwd_bf16_wgmma_kernel',
           'sum_partials_kernel')
LAUNCH = 'decode_loss_fwd_bf16_wgmma_kernel'


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
                                         bf16=True)['fwd'][0]
  return 100.0 * bound_ms / (seconds * 1e3 / launches)
