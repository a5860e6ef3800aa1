"""Build variants of the port's decode-loss kernels and time them in turns.

Run from the root of a checkout on a machine with one CUDA card:

    python3 tools/torch_fdl_variants.py [VARIANT ...]
    python3 tools/torch_fdl_variants.py --copies

Each variant is ``recoder_tpu_torch/kernels/fused_decode_loss.cu`` with
text patches applied; ``a+b`` applies both. The variants:

  committed  the source as it is: the TF32 split by integer rounding in
             the forward and drows kernels, by ``cvt.rna`` in dh's
  cvt        ``cvt.rna`` in all three products
  int        integer rounding in all three
  trunc_lo   the low part left unrounded (the tensor cores read its top
             19 bits, which truncates it)
  ldmatrix   K-major fragments loaded with ``ldmatrix.x4``

For each variant it prints the ptxas stack frame and spill bytes and the
HMMA count of every decode-loss kernel, checks loss and gradients against
the plain version (chip_smoke's tolerances), and times the forward (with
and without the E0 write) and the backward at [500, 200, 20,224], 'mse'
c=3, by device time (torch.profiler sums), in turns: the listed order,
then the reverse. The variant sources and libraries go to
``build/fdl_variants/`` (git-ignored). The last line is a JSON object of
the results.

``--copies`` times instead the bf16 wgmma route's choice to keep bf16
copies of h and rows for its backward (see :func:`copies`).
"""

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (the repository root, above)

SOURCE = os.path.join(ROOT, 'recoder_tpu_torch', 'kernels',
                      'fused_decode_loss.cu')
OUT_DIR = os.path.join(ROOT, 'build', 'fdl_variants')
DEFAULT = ('committed', 'cvt', 'int', 'trunc_lo', 'int+trunc_lo',
           'ldmatrix')
SHAPE = (500, 200, 20224)

_LDSM = '''
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// x = hi + lo, both TF32'''
_B_LOOP = '''#pragma unroll
    for (int ni = 0; ni < kNT; ++ni) {
      const int n = wn + ni * 8 + g;
      split_tf32<kOp>(tile_at<kBN, bk>(bs, n, kk + t), bh[ni][0], bl[ni][0]);
      split_tf32<kOp>(tile_at<kBN, bk>(bs, n, kk + t + 4), bh[ni][1],
                      bl[ni][1]);
    }
'''
_A_LOADS = '''\
      split_tf32<kOp>(tile_at<kBM, ak>(as, r, kk + t), ah[0], al[0]);
      split_tf32<kOp>(tile_at<kBM, ak>(as, r + 8, kk + t), ah[1], al[1]);
      split_tf32<kOp>(tile_at<kBM, ak>(as, r, kk + t + 4), ah[2], al[2]);
      split_tf32<kOp>(tile_at<kBM, ak>(as, r + 8, kk + t + 4), ah[3], al[3]);
'''
# (old, new) text pairs; each old text must occur exactly once
PATCHES = {
    'committed': [],
    'cvt': [('if constexpr (kOp == kDh) {', 'if constexpr (true) {')],
    'int': [('if constexpr (kOp == kDh) {', 'if constexpr (false) {')],
    'trunc_lo': [
        ('asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(lo) : "f"(rest));',
         'lo = __float_as_uint(rest);'),
        ('lo = (__float_as_uint(rest) + 0x1000u) & 0xffffe000u;',
         'lo = __float_as_uint(rest);')],
    'ldmatrix': [
        ('// x = hi + lo, both TF32', _LDSM),
        ('bk = b_kmajor(kOp);  // K-major?\n',
         'bk = b_kmajor(kOp);  // K-major?\n'
         '  const int lane = g * 4 + t, li = lane & 7, lj = lane >> 3;\n'),
        (_B_LOOP, '''    if constexpr (bk) {
#pragma unroll
      for (int ni = 0; ni < kNT; ni += 2) {
        uint32_t q[4];
        ldsm_x4(q, bs + (wn + (ni + (lj >> 1)) * 8 + li) * (kBK + kPadK) +
                       kk + 4 * (lj & 1));
        split_tf32<kOp>(__uint_as_float(q[0]), bh[ni][0], bl[ni][0]);
        split_tf32<kOp>(__uint_as_float(q[1]), bh[ni][1], bl[ni][1]);
        split_tf32<kOp>(__uint_as_float(q[2]), bh[ni + 1][0], bl[ni + 1][0]);
        split_tf32<kOp>(__uint_as_float(q[3]), bh[ni + 1][1], bl[ni + 1][1]);
      }
    } else {
''' + _B_LOOP + '    }\n'),
        (_A_LOADS, '''      if constexpr (ak) {
        uint32_t q[4];
        ldsm_x4(q, as + (wm + mi * 16 + li + 8 * (lj & 1)) * (kBK + kPadK) +
                       kk + 4 * (lj >> 1));
#pragma unroll
        for (int j = 0; j < 4; ++j)
          split_tf32<kOp>(__uint_as_float(q[j]), ah[j], al[j]);
      } else {
''' + _A_LOADS + '      }\n')],
}


def variant_source(name):
  with open(SOURCE) as f:
    src = f.read()
  for part in name.split('+'):
    for old, new in PATCHES[part]:
      if src.count(old) != 1:
        raise ValueError(f'{part}: the patch does not apply once: '
                         f'{old[:60]!r}')
      src = src.replace(old, new)
  return src


def build(name):
  """(path of the library, compiler log) of one variant."""
  from recoder_tpu_torch import kernels
  stem = os.path.join(OUT_DIR, name.replace('+', '_'))
  with open(stem + '.cu', 'w') as f:
    f.write(variant_source(name))
  proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, '-o',
                         stem + '.so', stem + '.cu'], capture_output=True,
                        text=True)
  if proc.returncode != 0:
    raise RuntimeError(f'{name}: nvcc failed\n{proc.stdout}{proc.stderr}')
  return stem + '.so', proc.stdout + proc.stderr


def use(lib):
  """Patch the wrapper to run ``lib`` (a ctypes library), bound and put
  in the kernels' cache in place of the source's build."""
  from recoder_tpu_torch import kernels
  from recoder_tpu_torch.ops import fused_decode_loss as fdl
  fdl._CONFIGURED.clear()
  fdl._plan.cache_clear()
  return mock.patch.dict(kernels._LIBS,
                         {fdl.LIBRARY.name: fdl.LIBRARY.bind(lib)})


def main(names):
  import ctypes
  import statistics

  import torch

  from recoder_tpu_torch.ops import fused_decode_loss as fdl
  card = cs.phase_device()
  os.makedirs(OUT_DIR, exist_ok=True)
  with ThreadPoolExecutor(max_workers=len(names)) as pool:
    built = dict(zip(names, pool.map(build, names)))
  results = {}
  for name, (path, log) in built.items():
    frames = cs.ptxas_frames(log)
    opcodes = cs.sass_opcodes(path)
    per_kernel = {}
    for kernel in cs.DECODE_LOSS_KERNELS:
      for func, ops in opcodes.items():
        if kernel in func:
          vec = 'ILb1E' in func
          per_kernel[f'{kernel}<{str(vec).lower()}>'] = {
              'hmma': ops['HMMA'] + ops['HGMMA'],
              'stack_spill_stores_loads': frames.get(func),
              'top_opcodes': dict(ops.most_common(6))}
    results[name] = {'kernels': per_kernel}
    cs.say(f'{name}: ' + '; '.join(
        f'{k} HMMA {v["hmma"]} stack/spill-st/spill-ld '
        f'{v["stack_spill_stores_loads"]}' for k, v in per_kernel.items()))
  libs = {name: ctypes.CDLL(path) for name, (path, _) in built.items()}

  for name in names:
    with use(libs[name]):
      for shape in ((37, 24, 1000), SHAPE, (9, 7, 130)):
        for kind, c in (('mse', 3.0), ('logistic', 0.0)):
          cs.compare_kernel(*shape, kind, c, 'cuda')
  cs.say('every variant within the tolerances at [37, 24, 1000], '
         '[500, 200, 20224], [9, 7, 130]')

  h, rows, bias, target, rm, cm = cs.make_problem(*SHAPE, 'cuda')
  g = torch.ones((), device='cuda')
  args = (target, rm, cm, 'mse', 3.0)
  times = {name: {'fwd': [], 'fwd_nograd': [], 'bwd': []} for name in names}
  for name in list(names) + list(names)[::-1]:
    with use(libs[name]):
      _, e0, _ = fdl._kernel_forward(h, rows, bias, *args, None, True)
      t = times[name]
      t['fwd'].append(cs.device_ms(
          lambda: fdl._kernel_forward(h, rows, bias, *args, None, True)))
      t['fwd_nograd'].append(cs.device_ms(
          lambda: fdl._kernel_forward(h, rows, bias, *args, None, False)))
      t['bwd'].append(cs.device_ms(
          lambda: fdl._kernel_backward(g, e0, h, rows)))
  for name in names:
    results[name]['ms'] = {k: statistics.mean(v)
                           for k, v in times[name].items()}
    cs.say(f'{name}: device ms at {list(SHAPE)} (mean of two turns) '
           + ', '.join(f'{k} {v:.4f}'
                       for k, v in results[name]['ms'].items()))
  cs.say(card)
  cs.say(json.dumps({'card': card, 'shape': SHAPE, 'variants': results}))


def copies(calls=4):
  """The wgmma route keeps the bf16 copies of h and rows ([bf16(h) | 1 |
  0..] and bf16(rows)) that its forward makes for the backward. Times, at
  SHAPE with a bf16 target, 'mse' c=3, by device time in ``calls`` turns:
  the forward with E0 and the rows copy (as training runs it), the same
  forward writing no rows copy (what a backward that casts again would
  be paired with), the backward from the copies, and the casts of h and
  rows to bf16 that such a backward would run first (PyTorch's cast
  kernels, the same bytes)."""
  import statistics

  import torch

  from recoder_tpu_torch.ops import fused_decode_loss as fdl
  card = cs.phase_device()
  B, d, W = SHAPE
  h, rows, bias, target, rm, cm = cs.make_problem(*SHAPE, 'cuda')
  target = target.bfloat16()
  args = (target, rm, cm, 'mse', 3.0, 'bfloat16')
  g = torch.ones((), device='cuda')
  assert fdl.bf16_route(h, rows, target) == 'wgmma'
  _, e0, kept = fdl._kernel_forward(h, rows, bias, *args, True)
  lib = fdl._device_lib(h.device)
  n_partials, _, _, _, _ = fdl._plan_wgmma(h.device.index, B, W, d)
  partials = torch.empty(n_partials, device='cuda')
  out = torch.empty((), device='cuda')
  hb = torch.empty_like(kept[0])

  def forward_without_copy():
    lib.fdl_forward_wgmma(
        h.data_ptr(), rows.data_ptr(), 0, bias.data_ptr(),
        target.data_ptr(), fdl.target_stride(target), rm.data_ptr(),
        cm.data_ptr(), B, W, d,
        fdl.KINDS['mse'], 3.0,
        hb.data_ptr(), None, e0.data_ptr(), n_partials, partials.data_ptr(),
        out.data_ptr(), h.device.index,
        torch.cuda.current_stream().cuda_stream)

  steps = {
      'fwd': lambda: fdl._kernel_forward(h, rows, bias, *args, True),
      'fwd_without_rows_copy': forward_without_copy,
      'bwd_from_copies': lambda: fdl._kernel_backward(g, e0, h, rows, kept),
      'cast_h_and_rows': lambda: (h.bfloat16(), rows.bfloat16())}
  runs = {name: [] for name in steps}
  for turn in range(calls):
    for name in (list(steps) if turn % 2 == 0 else list(steps)[::-1]):
      runs[name].append(cs.device_ms(steps[name]))
  ms = {name: statistics.mean(v) for name, v in runs.items()}
  cs.say(f'wgmma route at {list(SHAPE)} bf16 target, mse c=3, device ms '
         f'(mean of {calls} turns): ' + ', '.join(
             f'{k} {v:.4f}' for k, v in ms.items()))
  cs.say(f'keeping the copies costs the forward '
         f'{ms["fwd"] - ms["fwd_without_rows_copy"]:.4f} ms; casting again '
         f'would cost the backward {ms["cast_h_and_rows"]:.4f} ms')
  cs.say(card)
  cs.say(json.dumps({'card': card, 'shape': SHAPE, 'copies_ms': ms}))


if __name__ == '__main__':
  if sys.argv[1:] == ['--copies']:
    copies()
  else:
    main(tuple(sys.argv[1:]) or DEFAULT)
