"""Device milliseconds a step of the library's matrix products (cuBLAS
and CUTLASS kernels, found by the name patterns below) in the profiled
slice: the encoder's products, and the decoder's where no fused
decode-loss kernel takes it (logloss)."""

LAYER = 'model products'
MOVES = 'train_batches_per_s'
#: substrings of the library's GEMM kernel names (lower case)
PATTERNS = ('gemm', 'nvjet', 'xmma', 'cutlass', 'splitkreduce')
#: the program's own kernels, never counted here
HAND = ('decode_loss', 'drows_dbias', 'dh_', 'sum_partials', 'sum_splits',
        'cast_operands', 'adam_', 'packed_rows', 'col_mask', 'row_scatter',
        'spd_solve')


def is_gemm(name):
  low = name.lower()
  return (any(p in low for p in PATTERNS)
          and not any(h in low for h in HAND))


def read(run):
  if run.slice is None or not run.slice_steps:
    return None
  seconds = run.slice.seconds(is_gemm)
  return seconds * 1e3 / run.slice_steps if seconds else None
