"""Fused decode-score + masked loss: the CUDA kernels and their plain twins.

Port of ``recoder_tpu/experiments/pallas_loss.py`` (``fused_decode_loss``,
a ``jax.custom_vjp`` over the Pallas kernels ``_fwd_kernel`` and
``_bwd_kernel``). It returns the masked SUM loss

    sum_ij loss(h @ rows.T + bias, target)_ij * row_mask_i * col_mask_j

for 'mse' (confidence-weighted) and 'logistic' (BCE with logits), with
gradients for ``h``, ``rows`` and ``bias``; the [B, W] score matrix never
reaches device memory. 'logloss' needs a whole-row softmax normalizer and
stays on the plain path (decode matmul plus ``ops/losses.py``), as in the
JAX package.

On the JAX side the kernel stayed unwired (XLA's fusion beat it on the
TPU). Here the training step calls it for 'mse' and 'logistic'.

The forward computes each score tile once. When a backward can follow
(the autograd graph records the call), it also stashes the cotangent
``E0 = loss'(S, T) * row_mask * col_mask`` ([B, W] float32), and the
backward is two products over E0 with the upstream gradient ``g`` applied
on the device; under ``torch.no_grad()`` no E0 is written.

``compute_dtype='bfloat16'`` selects the bf16 variant (the JAX
package's decode at ``compute_dtype='bfloat16'``): ``h`` and ``rows``
stay float32 tensors and are rounded to bf16 inside the kernels, the
products accumulate in float32, the score is rounded to bf16 before the
float32 loss, and E0 is stored in bf16; dh and drows come back rounded
to bf16 values, dbias in float32 (the rounding points are listed in the
kernel source's header).

bf16 parameter storage (``params_dtype='bfloat16'``): ``rows`` (and, for
MatrixFactorization, ``h``) and ``bias`` may be bf16 tensors. The bf16
kernels read bf16 rows as they are stored -- the wgmma backward takes the
table itself as its TMA operand, where the forward of float32 rows
writes a bf16 copy -- and write drows in bf16; a bf16 ``h`` and ``bias``
are upcast in the wrapper (a batch's activations and one [W] vector:
exact), and dh and dbias are rounded once to their inputs' dtype. At
float32 compute over bf16 storage (bench.py's ``--dtype float32
--params-dtype bfloat16``) the 3xTF32 kernels take a float32 copy of the
rows, a plain ``.float()`` outside the kernel, and write drows in bf16.
Every gradient comes back in its input's dtype, rounded once from its
float32 value, as the JAX package's ``astype`` transposes round.

A captured CUDA graph may record the call (the trainer's captured
full-decode step): nothing in it reads the host, and the launch plan of
a shape (``_plan``) and the kernels' shared-memory limits are set at its
first, eager, call -- the trainer's warm-up steps -- so that a capture
records launches only. The E0 stash and its routing through
``ctx.next_functions`` are autograd's and work the same under capture.

Routing is by the tensors' device and the compute dtype: CUDA tensors
launch the kernels of ``kernels/fused_decode_loss.cu`` for that dtype
(or raise), CPU tensors take the plain versions of the same two steps
(:func:`_plain_forward`, :func:`_plain_backward`). The bf16 variant has
two sets of hand kernels, chosen by shape (:func:`bf16_route`): 'wgmma'
(TMA-fed tiles and warpgroup products, where TMA can describe every
operand: bench.py's ML-20M step takes it) and 'mma' (the ``mma.sync``
kernels, which take any shape: the ragged union widths). Each route has
its launch counters; a call the route does not take raises.
"""

import ctypes
import functools
import threading

import torch

from recoder_tpu_torch.kernels import count_launch
from recoder_tpu_torch.ops import losses as losses_lib
from recoder_tpu_torch.ops.gather_matmul import as_dtype, decode_matmul

KINDS = {'mse': 0, 'logistic': 1}
BF16 = torch.bfloat16
#: target dtypes the kernel reads (it upcasts in registers, as the JAX
#: kernel casts ``t``)
TARGET_DTYPES = (torch.float32, torch.bfloat16)
#: kernel launches since the last reset, one count per kernel
LAUNCHES = {'fused_decode_loss_fwd': 0, 'fused_decode_loss_bwd': 0,
            'fused_decode_loss_fwd_bf16': 0, 'fused_decode_loss_bwd_bf16': 0,
            'fused_decode_loss_fwd_bf16_wgmma': 0,
            'fused_decode_loss_bwd_bf16_wgmma': 0}
#: the feature widths d the wgmma kernels are compiled for (the wgmma
#: width is an immediate; ``kWgD`` in the source): bench.py's ML-20M step
WGMMA_WIDTHS = (200,)

_LIB = None
_LIB_LOCK = threading.Lock()
#: device indices whose kernels have their shared-memory limits set
_CONFIGURED = set()


def supported(kind):
  """Whether the fused kernel covers this loss."""
  return kind in KINDS


def bf16_route(h, rows, target):
  """Which bf16 kernels take a call of this shape: 'wgmma' where TMA can
  describe every operand -- a bfloat16 target whose rows are whole
  16-byte runs (W % 8 == 0), a feature width in ``WGMMA_WIDTHS``, 16-byte
  aligned rows (read 16 bytes at a time) and target -- else 'mma'. (The kernels read h through a bf16 copy of
  their own.)"""
  d, W = h.shape[-1], rows.shape[0]
  ok = (target.dtype == BF16 and W % 8 == 0 and d in WGMMA_WIDTHS
        and rows.data_ptr() % 16 == 0 and target.data_ptr() % 16 == 0)
  return 'wgmma' if ok else 'mma'


def _masked_loss_sum(scores, target, row_mask, col_mask, kind, confidence):
  if kind == 'mse':
    loss = losses_lib.mse_loss(scores, target, confidence=confidence,
                               row_mask=row_mask, col_mask=col_mask)
  elif kind == 'logistic':
    loss = losses_lib.logistic_loss(scores, target, row_mask=row_mask,
                                    col_mask=col_mask)
  else:
    raise ValueError(f'fused decode loss does not cover {kind!r}')
  return torch.sum(loss)


def _is_bf16(compute_dtype):
  return as_dtype(compute_dtype) == BF16


def _round(x):
  """``x`` rounded to bf16 values, kept in float32."""
  return x.to(BF16).float()


def fused_decode_loss_plain(h, rows, bias, target, row_mask, col_mask,
                            kind='mse', confidence=0.0, compute_dtype=None):
  """Plain PyTorch version: decode matmul (scores in the compute dtype),
  then the masked loss, summed; autograd gives the gradients."""
  scores = decode_matmul(h, rows, bias, compute_dtype)
  if _is_bf16(compute_dtype):
    scores = scores.to(BF16)
  return _masked_loss_sum(scores, target, row_mask, col_mask, kind,
                          confidence)


def _cotangent(scores, target, row_mask, col_mask, kind, confidence):
  """E0 = d loss / d S without the upstream gradient, float32 [B, W]."""
  t = target.float()
  if kind == 'mse':
    w = 1.0 + confidence * (t > 0).float()
    ds = 2.0 * w * (scores - t)
  else:
    ds = torch.sigmoid(scores) - t
  return ds * (row_mask[:, None] * col_mask[None, :])


def _plain_backward(g, e0, h, rows):
  """The kernel backward's plain version: gradients w.r.t. h, rows and
  bias from the forward's cotangent E0 (bf16 E0: the bf16 variant's,
  with its bf16 operands and roundings), float32. bf16 operands are
  upcast first (exact)."""
  h, rows = h.float(), rows.float()
  if e0.dtype == BF16:
    ds = e0.float()
    dh = _round(g * torch.matmul(ds, _round(rows)))
    drows = _round(g * torch.matmul(ds.t(), _round(h)))
    return dh, drows, g * torch.sum(ds, 0)
  ds = e0 * g
  return torch.matmul(ds, rows), torch.matmul(ds.t(), h), torch.sum(ds, 0)


def _plain_forward(h, rows, bias, target, row_mask, col_mask, kind,
                   confidence, compute_dtype, stash):
  """The kernel forward's plain version: the loss and, when ``stash``,
  E0 (else None), both from one score product. bf16 operands (bf16
  parameter storage) are upcast first: exact, so the result is bitwise
  that of float32 operands holding the same values."""
  h, rows, bias = h.float(), rows.float(), bias.float()
  bf16 = _is_bf16(compute_dtype)
  if bf16:
    scores = _round(torch.matmul(_round(h), _round(rows).t()) + bias)
  else:
    scores = torch.matmul(h, rows.t()) + bias
  loss = _masked_loss_sum(scores, target, row_mask, col_mask, kind,
                          confidence)
  e0 = None
  if stash:
    e0 = _cotangent(scores, target, row_mask, col_mask, kind, confidence)
    if bf16:
      e0 = e0.to(BF16)
  return loss, e0


def _lib():
  global _LIB
  with _LIB_LOCK:
    if _LIB is None:
      from recoder_tpu_torch.kernels import load_library
      lib = load_library('fused_decode_loss')
      ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
      lib.fdl_forward.argtypes = ([ptr] * 4 + [i32] + [ptr] * 2 + [i32] * 4
                                  + [f32, i32, i32, ptr, i32, ptr, ptr, i32,
                                     ptr])
      lib.fdl_forward.restype = i32
      lib.fdl_backward.argtypes = ([ptr] * 2 + [i32] + [ptr] * 2 + [i32] * 7
                                   + [ptr] * 3 + [i32, ptr, i32, ptr])
      lib.fdl_backward.restype = i32
      lib.fdl_max_d.restype = i32
      lib.max_d = lib.fdl_max_d()  # the widest feature axis it takes
      lib.fdl_plan.argtypes = [i32] * 5 + [ctypes.POINTER(i32)]
      lib.fdl_plan.restype = i32
      lib.fdl_plan_wgmma.argtypes = [i32] * 4 + [ctypes.POINTER(i32)]
      lib.fdl_plan_wgmma.restype = i32
      lib.fdl_forward_wgmma.argtypes = ([ptr] * 2 + [i32] + [ptr] * 4
                                        + [i32] * 4 + [f32] + [ptr] * 3
                                        + [i32] + [ptr] * 2 + [i32, ptr])
      lib.fdl_forward_wgmma.restype = i32
      lib.fdl_backward_wgmma.argtypes = ([ptr] * 4 + [i32] * 5 + [ptr] * 3
                                         + [i32, ptr, i32, ptr])
      lib.fdl_backward_wgmma.restype = i32
      lib.fdl_configure.argtypes = [i32]
      lib.fdl_configure.restype = i32
      lib.fdl_error_string.argtypes = [i32]
      lib.fdl_error_string.restype = ctypes.c_char_p
      _LIB = lib
    return _LIB


def _check(lib, err, what):
  if err != 0:
    raise RuntimeError(f'{what} failed: CUDA error {err} '
                       f'({lib.fdl_error_string(err).decode()})')


def _device_lib(device):
  """The library, its kernels configured for ``device`` (once)."""
  lib = _lib()
  if device.index not in _CONFIGURED:
    with _LIB_LOCK:
      _check(lib, lib.fdl_configure(device.index), 'fdl_configure')
      _CONFIGURED.add(device.index)
  return lib


@functools.lru_cache(maxsize=1024)
def _plan(device_index, B, W, d, bf16):
  """(forward partials, k tiles per dh split, dh splits, E0 row stride)
  of one shape; about two dh blocks per SM."""
  lib = _lib()
  sms = torch.cuda.get_device_properties(device_index).multi_processor_count
  out = (ctypes.c_int * 4)()
  _check(lib, lib.fdl_plan(B, W, d, sms, int(bf16), out), 'fdl_plan')
  return tuple(out)


@functools.lru_cache(maxsize=1024)
def _plan_wgmma(device_index, B, W, d):
  """(forward blocks and partials, 64-item chunks per dh split, dh
  splits, E0 row stride, hb row stride) of one shape on the wgmma route:
  one forward block an SM, about one dh block an SM."""
  lib = _lib()
  sms = torch.cuda.get_device_properties(device_index).multi_processor_count
  out = (ctypes.c_int * 5)()
  _check(lib, lib.fdl_plan_wgmma(B, W, d, sms, out), 'fdl_plan_wgmma')
  return tuple(out)


#: dtypes the kernels' wrapper takes for h, rows and bias (bf16: bf16
#: parameter storage)
OPERAND_DTYPES = (torch.float32, torch.bfloat16)


def _validate(h, rows, bias, target, row_mask, col_mask, kind, max_d):
  if kind not in KINDS:
    raise ValueError(f'fused decode loss does not cover {kind!r}')
  named = {'h': h, 'rows': rows, 'bias': bias, 'target': target,
           'row_mask': row_mask, 'col_mask': col_mask}
  for name, x in named.items():
    if x.device != h.device:
      raise ValueError(f'{name} is on {x.device}, h on {h.device}')
    allowed = (TARGET_DTYPES if name == 'target' else OPERAND_DTYPES
               if name in ('h', 'rows', 'bias') else (torch.float32,))
    if x.dtype not in allowed:
      raise ValueError(f'{name} must be one of {allowed}, got {x.dtype}')
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
  if not 1 <= d <= max_d:
    raise ValueError(f'feature width {d} outside 1..{max_d}')
  return B, W, d


def _kernel_forward(h, rows, bias, target, row_mask, col_mask, kind,
                    confidence, compute_dtype, stash, route=None):
  """The loss on the card; when ``stash``, E0 as [B, lde] (its rows
  padded with zeros to a multiple of 4 columns, float32; to 8, bf16, for
  the bf16 variant; else None), and on the wgmma route the bf16 operands
  (hb, rows_b) that its backward reads (else None): rows_b is a copy the
  forward writes from float32 rows, or bf16 rows themselves. ``route``:
  the bf16 kernels ('wgmma' or 'mma'), by default :func:`bf16_route`'s.
  A bf16 ``h`` or ``bias`` is upcast here (exact); the 3xTF32 kernels
  take a float32 copy of bf16 rows.

  Returns (loss, e0, copies)."""
  bf16 = _is_bf16(compute_dtype)  # (raises on another compute dtype)
  lib = _device_lib(h.device)
  B, W, d = _validate(h, rows, bias, target, row_mask, col_mask, kind,
                      lib.max_d)
  h, bias = h.float(), bias.float()
  if bf16 and (route or bf16_route(h, rows, target)) == 'wgmma':
    return _wgmma_forward(lib, h, rows, bias, target, row_mask, col_mask,
                          kind, confidence, stash)
  rows_bf16 = bf16 and rows.dtype == BF16
  rows = rows if bf16 else rows.float()
  n_partials, _, _, lde = _plan(h.device.index, B, W, d, bf16)
  partials = torch.empty(n_partials, device=h.device)
  out = torch.empty((), device=h.device)
  e0 = (torch.empty((B, lde), device=h.device,
                    dtype=BF16 if bf16 else torch.float32)
        if stash else None)
  stream = torch.cuda.current_stream(h.device).cuda_stream
  err = lib.fdl_forward(
      h.data_ptr(), rows.data_ptr(), bias.data_ptr(), target.data_ptr(),
      int(target.dtype == torch.bfloat16), row_mask.data_ptr(),
      col_mask.data_ptr(), B, W, d, KINDS[kind], float(confidence),
      int(bf16), int(rows_bf16), e0.data_ptr() if stash else None, lde,
      partials.data_ptr(), out.data_ptr(), h.device.index, stream)
  _check(lib, err, 'fused decode-loss forward launch')
  count_launch(LAUNCHES, 'fused_decode_loss_fwd_bf16' if bf16
               else 'fused_decode_loss_fwd')
  return out, e0, None


def _wgmma_forward(lib, h, rows, bias, target, row_mask, col_mask, kind,
                   confidence, stash):
  (B, d), W = h.shape, rows.shape[0]
  n_partials, _, _, lde, dp = _plan_wgmma(h.device.index, B, W, d)
  dev = h.device
  partials = torch.empty(n_partials, device=dev)
  out = torch.empty((), device=dev)
  hb = torch.empty((B, dp), device=dev, dtype=BF16)
  rows_bf16 = rows.dtype == BF16
  # (bf16 rows are the backward's operand as they are: nothing writes
  # them before it, the optimizer steps after the backward)
  rows_b = (rows if rows_bf16 else
            torch.empty((W, d), device=dev, dtype=BF16)) if stash else None
  e0 = torch.empty((B, lde), device=dev, dtype=BF16) if stash else None
  stream = torch.cuda.current_stream(dev).cuda_stream
  err = lib.fdl_forward_wgmma(
      h.data_ptr(), rows.data_ptr(), int(rows_bf16), bias.data_ptr(),
      target.data_ptr(), row_mask.data_ptr(), col_mask.data_ptr(), B, W, d,
      KINDS[kind], float(confidence), hb.data_ptr(),
      None if rows_b is None or rows_bf16 else rows_b.data_ptr(),
      None if e0 is None else e0.data_ptr(), n_partials, partials.data_ptr(),
      out.data_ptr(), dev.index, stream)
  _check(lib, err, 'fused decode-loss forward launch (wgmma)')
  count_launch(LAUNCHES, 'fused_decode_loss_fwd_bf16_wgmma')
  return out, e0, (hb, rows_b) if stash else None


def _wgmma_backward(lib, g, e0, h, rows, copies, drows_dtype):
  (B, d), W = h.shape, rows.shape[0]
  _, per, nsplit, lde, dp = _plan_wgmma(h.device.index, B, W, d)
  if e0.shape != (B, lde) or e0.dtype != BF16:
    raise ValueError(f'E0 is {tuple(e0.shape)} {e0.dtype}, expected '
                     f'{(B, lde)} bfloat16')
  dev = h.device
  hb, rows_b = copies
  if hb.shape != (B, dp) or rows_b.shape != (W, d) or \
      hb.dtype != BF16 or rows_b.dtype != BF16:
    raise ValueError(f'bf16 copies {tuple(hb.shape)} {tuple(rows_b.shape)},'
                     f' expected {(B, dp)} and {(W, d)} bfloat16')
  g = g.to(device=dev, dtype=torch.float32).contiguous()
  dh_partials = torch.empty((nsplit, B, d), device=dev)
  dh = torch.empty((B, d), device=dev)
  drows = torch.empty((W, d), device=dev, dtype=drows_dtype)
  dbias = torch.empty((W,), device=dev)
  stream = torch.cuda.current_stream(dev).cuda_stream
  err = lib.fdl_backward_wgmma(
      g.data_ptr(), e0.data_ptr(), hb.data_ptr(), rows_b.data_ptr(), B, W,
      d, per, nsplit, dh_partials.data_ptr(), dh.data_ptr(),
      drows.data_ptr(), int(drows_dtype == BF16), dbias.data_ptr(),
      dev.index, stream)
  _check(lib, err, 'fused decode-loss backward launch (wgmma)')
  count_launch(LAUNCHES, 'fused_decode_loss_bwd_bf16_wgmma')
  return dh, drows, dbias


def _kernel_backward(g, e0, h, rows, copies=None):
  """dh, drows, dbias on the card from the forward's E0 (a bf16 E0: the
  bf16 variant) and, from a wgmma forward, its bf16 ``copies``: the wgmma
  backward exactly when they are given. drows comes in ``rows``' dtype,
  dh and dbias in float32 (a bf16 ``h`` is upcast, exact)."""
  lib = _device_lib(h.device)
  h = h.float()
  if copies is not None:
    return _wgmma_backward(lib, g, e0, h, rows, copies, rows.dtype)
  (B, d), W = h.shape, rows.shape[0]
  bf16 = e0.dtype == BF16
  drows_dtype = rows.dtype
  rows_bf16 = bf16 and rows.dtype == BF16
  rows = rows if bf16 else rows.float()
  _, ktiles, nsplit, lde = _plan(h.device.index, B, W, d, bf16)
  if e0.shape != (B, lde):
    raise ValueError(f'E0 is {tuple(e0.shape)}, expected {(B, lde)}')
  g = g.to(device=h.device, dtype=torch.float32).contiguous()
  dh_partials = torch.empty((nsplit, B, d), device=h.device)
  dh = torch.empty((B, d), device=h.device)
  drows = torch.empty((W, d), device=h.device, dtype=drows_dtype)
  dbias = torch.empty((W,), device=h.device)
  stream = torch.cuda.current_stream(h.device).cuda_stream
  err = lib.fdl_backward(
      g.data_ptr(), e0.data_ptr(), lde, h.data_ptr(), rows.data_ptr(),
      int(rows_bf16), B, W, d, ktiles, nsplit, int(bf16),
      dh_partials.data_ptr(), dh.data_ptr(), drows.data_ptr(),
      int(drows_dtype == BF16), dbias.data_ptr(), h.device.index, stream)
  _check(lib, err, 'fused decode-loss backward launch')
  count_launch(LAUNCHES, 'fused_decode_loss_bwd_bf16' if bf16
               else 'fused_decode_loss_bwd')
  return dh, drows, dbias


def _route(device):
  if device.type == 'cuda':
    return True
  if device.type == 'cpu':
    return False
  raise ValueError(f'fused decode loss runs on cuda or cpu, not {device}')


def _will_backward(ctx):
  """Whether autograd recorded this call with an edge to h, rows or bias:
  only then can a backward follow. (``ctx.needs_input_grad`` reads the
  inputs' ``requires_grad`` and stays True under ``torch.no_grad()``; the
  node's edges are empty there.)"""
  return any(fn is not None for fn, _ in ctx.next_functions[:3])


class FusedDecodeLoss(torch.autograd.Function):
  """Autograd wrapper: the CUDA kernels on CUDA tensors, their plain
  versions on CPU tensors. Each gradient comes back in its input's
  dtype (a bf16 parameter's rounded once from float32)."""

  @staticmethod
  def forward(ctx, h, rows, bias, target, row_mask, col_mask, kind,
              confidence, compute_dtype):
    stash = _will_backward(ctx)
    ctx.dtypes = (h.dtype, bias.dtype)
    args = (h, rows, bias, target, row_mask, col_mask, kind, confidence,
            compute_dtype, stash)
    if _route(h.device):
      loss, e0, copies = _kernel_forward(*args)
    else:
      (loss, e0), copies = _plain_forward(*args), None
    if stash:
      ctx.save_for_backward(e0, h, rows, *(copies or ()))
    return loss

  @staticmethod
  def backward(ctx, g):
    e0, h, rows, *copies = ctx.saved_tensors
    if _route(h.device):
      dh, drows, dbias = _kernel_backward(g, e0, h, rows, copies or None)
    else:
      dh, drows, dbias = _plain_backward(g, e0, h, rows)
      drows = drows.to(rows.dtype)
    h_dtype, bias_dtype = ctx.dtypes
    return (dh.to(h_dtype), drows, dbias.to(bias_dtype), None, None, None,
            None, None, None)


def fused_decode_loss(h, rows, bias, target, row_mask, col_mask,
                      kind='mse', confidence=0.0, compute_dtype=None):
  """Masked sum loss of ``h @ rows.T + bias`` against ``target``.

  Args:
    h: [B, d] bottleneck activations.
    rows: [W, d] decoder table.
    bias: [W] decoder bias.
    target: [B, W] dense targets, float32 or bfloat16.
    row_mask: [B] 1.0 for valid users.
    col_mask: [W] 1.0 for the loss columns.
    kind: 'mse' | 'logistic'.
    confidence: positive-observation weight for 'mse'.
    compute_dtype: None or 'float32' (the 3xTF32 kernels), or
      'bfloat16' (the bf16 variant).

  Returns the scalar sum loss, differentiable w.r.t. h, rows and bias.
  """
  return FusedDecodeLoss.apply(h, rows, bias, target, row_mask, col_mask,
                               kind, confidence, compute_dtype)
