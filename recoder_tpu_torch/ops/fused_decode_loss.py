"""Fused decode-score + masked loss: the CUDA kernel and its plain twin.

Port of ``recoder_tpu/experiments/pallas_loss.py`` (``fused_decode_loss``,
a ``jax.custom_vjp`` over the Pallas kernels ``_fwd_kernel`` and
``_bwd_kernel``). It returns the masked SUM loss

    sum_ij loss(h @ rows.T + bias, target)_ij * row_mask_i * col_mask_j

for 'mse' (confidence-weighted) and 'logistic' (BCE with logits), with
gradients for ``h``, ``rows`` and ``bias``; the [B, W] score matrix and
its cotangent never reach device memory. 'logloss' needs a whole-row
softmax normalizer and stays on the plain path (decode matmul plus
``ops/losses.py``), as in the JAX package.

On the JAX side the kernel stayed unwired (XLA's fusion beat it on the
TPU). Here the training step calls it for 'mse' and 'logistic'.

Routing is by the tensors' device and nothing else: CUDA tensors launch
the kernels of ``kernels/fused_decode_loss.cu`` (or raise), CPU tensors
take :func:`fused_decode_loss_plain` and its explicit backward.
"""

import ctypes
import threading

import torch

from recoder_tpu_torch.ops import losses as losses_lib

KINDS = {'mse': 0, 'logistic': 1}

#: kernel launches since the last reset, one count per kernel
LAUNCHES = {'fused_decode_loss_fwd': 0, 'fused_decode_loss_bwd': 0}

_LIB = None
_LIB_LOCK = threading.Lock()


def supported(kind):
  """Whether the fused kernel covers this loss."""
  return kind in KINDS


def fused_decode_loss_plain(h, rows, bias, target, row_mask, col_mask,
                            kind='mse', confidence=0.0):
  """Plain PyTorch version: decode matmul, then the masked loss, summed."""
  scores = torch.matmul(h, rows.t()) + bias
  if kind == 'mse':
    loss = losses_lib.mse_loss(scores, target, confidence=confidence,
                               row_mask=row_mask, col_mask=col_mask)
  elif kind == 'logistic':
    loss = losses_lib.logistic_loss(scores, target, row_mask=row_mask,
                                    col_mask=col_mask)
  else:
    raise ValueError(f'fused decode loss does not cover {kind!r}')
  return torch.sum(loss)


def _plain_backward(g, h, rows, bias, target, row_mask, col_mask, kind,
                    confidence):
  """Gradients of :func:`fused_decode_loss_plain` w.r.t. h, rows, bias,
  written out as the kernel computes them."""
  scores = torch.matmul(h, rows.t()) + bias
  t = target.float()
  if kind == 'mse':
    w = 1.0 + confidence * (t > 0).float()
    ds = 2.0 * w * (scores - t)
  else:
    ds = torch.sigmoid(scores) - t
  ds = ds * (g * row_mask[:, None] * col_mask[None, :])
  return torch.matmul(ds, rows), torch.matmul(ds.t(), h), torch.sum(ds, 0)


def _lib():
  global _LIB
  with _LIB_LOCK:
    if _LIB is None:
      from recoder_tpu_torch.kernels import load_library
      lib = load_library('fused_decode_loss')
      ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
      lib.fdl_forward.argtypes = ([ptr] * 6 + [i32] * 4
                                  + [f32, i32, ptr, ptr, i32, ptr])
      lib.fdl_forward.restype = i32
      lib.fdl_backward.argtypes = ([ptr] * 7 + [i32] * 4
                                   + [f32, i32] + [ptr] * 4 + [i32, ptr])
      lib.fdl_backward.restype = i32
      lib.fdl_error_string.argtypes = [i32]
      lib.fdl_error_string.restype = ctypes.c_char_p
      lib.fdl_max_d.restype = i32
      lib.fdl_row_tile.restype = i32
      lib.fdl_num_splits.argtypes = [i32, i32, i32, ctypes.POINTER(i32)]
      lib.fdl_num_splits.restype = i32
      _LIB = lib
    return _LIB


def _check(lib, err, what):
  if err != 0:
    raise RuntimeError(f'{what} failed: CUDA error {err} '
                       f'({lib.fdl_error_string(err).decode()})')


def _validate(h, rows, bias, target, row_mask, col_mask, kind, lib):
  if kind not in KINDS:
    raise ValueError(f'fused decode loss does not cover {kind!r}')
  named = {'h': h, 'rows': rows, 'bias': bias, 'target': target,
           'row_mask': row_mask, 'col_mask': col_mask}
  for name, x in named.items():
    if x.device != h.device:
      raise ValueError(f'{name} is on {x.device}, h on {h.device}')
    if x.dtype != torch.float32:
      raise ValueError(f'{name} must be float32, got {x.dtype}')
    if not x.is_contiguous():
      raise ValueError(f'{name} must be contiguous')
  B, d = h.shape
  W = rows.shape[0]
  if (rows.shape != (W, d) or bias.shape != (W,)
      or target.shape != (B, W) or row_mask.shape != (B,)
      or col_mask.shape != (W,)):
    raise ValueError(
        f'shape mismatch: h {tuple(h.shape)} rows {tuple(rows.shape)} '
        f'bias {tuple(bias.shape)} target {tuple(target.shape)} '
        f'row_mask {tuple(row_mask.shape)} col_mask {tuple(col_mask.shape)}')
  if not 1 <= d <= lib.fdl_max_d():
    raise ValueError(f'feature width {d} outside 1..{lib.fdl_max_d()}')
  return B, W, d


def _grid(lib, B, W, device):
  """(batch tiles, W splits) of the forward and dh grids."""
  nsplit = ctypes.c_int(0)
  _check(lib, lib.fdl_num_splits(B, W, device.index or 0,
                                 ctypes.byref(nsplit)), 'fdl_num_splits')
  return -(-B // lib.fdl_row_tile()), nsplit.value


def _kernel_forward(h, rows, bias, target, row_mask, col_mask, kind,
                    confidence):
  lib = _lib()
  B, W, d = _validate(h, rows, bias, target, row_mask, col_mask, kind, lib)
  n_btiles, nsplit = _grid(lib, B, W, h.device)
  partials = torch.empty(n_btiles * nsplit, device=h.device)
  out = torch.empty((), device=h.device)
  stream = torch.cuda.current_stream(h.device).cuda_stream
  err = lib.fdl_forward(
      h.data_ptr(), rows.data_ptr(), bias.data_ptr(), target.data_ptr(),
      row_mask.data_ptr(), col_mask.data_ptr(), B, W, d, KINDS[kind],
      float(confidence), nsplit, partials.data_ptr(), out.data_ptr(),
      h.device.index or 0, stream)
  _check(lib, err, 'fused decode-loss forward launch')
  LAUNCHES['fused_decode_loss_fwd'] += 1
  return out


def _kernel_backward(g, h, rows, bias, target, row_mask, col_mask, kind,
                     confidence):
  lib = _lib()
  B, W, d = _validate(h, rows, bias, target, row_mask, col_mask, kind, lib)
  g = g.to(device=h.device, dtype=torch.float32).contiguous()
  _, nsplit = _grid(lib, B, W, h.device)
  dh_partials = torch.empty((nsplit, B, d), device=h.device)
  dh = torch.empty((B, d), device=h.device)
  drows = torch.empty((W, d), device=h.device)
  dbias = torch.empty((W,), device=h.device)
  stream = torch.cuda.current_stream(h.device).cuda_stream
  err = lib.fdl_backward(
      g.data_ptr(), h.data_ptr(), rows.data_ptr(), bias.data_ptr(),
      target.data_ptr(), row_mask.data_ptr(), col_mask.data_ptr(), B, W, d,
      KINDS[kind], float(confidence), nsplit, dh_partials.data_ptr(),
      dh.data_ptr(), drows.data_ptr(), dbias.data_ptr(),
      h.device.index or 0, stream)
  _check(lib, err, 'fused decode-loss backward launch')
  LAUNCHES['fused_decode_loss_bwd'] += 1
  return dh, drows, dbias


def _route(device):
  if device.type == 'cuda':
    return True
  if device.type == 'cpu':
    return False
  raise ValueError(f'fused decode loss runs on cuda or cpu, not {device}')


class FusedDecodeLoss(torch.autograd.Function):
  """Autograd wrapper: the CUDA kernels on CUDA tensors, the plain
  version on CPU tensors."""

  @staticmethod
  def forward(ctx, h, rows, bias, target, row_mask, col_mask, kind,
              confidence):
    ctx.save_for_backward(h, rows, bias, target, row_mask, col_mask)
    ctx.kind = kind
    ctx.confidence = confidence
    if _route(h.device):
      return _kernel_forward(h, rows, bias, target, row_mask, col_mask,
                             kind, confidence)
    return fused_decode_loss_plain(h, rows, bias, target, row_mask,
                                   col_mask, kind, confidence)

  @staticmethod
  def backward(ctx, g):
    h, rows, bias, target, row_mask, col_mask = ctx.saved_tensors
    fn = _kernel_backward if _route(h.device) else _plain_backward
    dh, drows, dbias = fn(g, h, rows, bias, target, row_mask, col_mask,
                          ctx.kind, ctx.confidence)
    return dh, drows, dbias, None, None, None, None, None


def fused_decode_loss(h, rows, bias, target, row_mask, col_mask,
                      kind='mse', confidence=0.0):
  """Masked sum loss of ``h @ rows.T + bias`` against ``target``.

  Args:
    h: [B, d] bottleneck activations.
    rows: [W, d] decoder table.
    bias: [W] decoder bias.
    target: [B, W] dense targets.
    row_mask: [B] 1.0 for valid users.
    col_mask: [W] 1.0 for the loss columns.
    kind: 'mse' | 'logistic'.
    confidence: positive-observation weight for 'mse'.

  Returns the scalar sum loss, differentiable w.r.t. h, rows and bias.
  """
  return FusedDecodeLoss.apply(h, rows, bias, target, row_mask, col_mask,
                               kind, confidence)
