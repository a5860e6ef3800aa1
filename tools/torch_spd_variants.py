"""Build variants of the port's SPD-solve kernel and time them in turns.

Run from the root of a checkout on a machine with one CUDA card:

    python3 tools/torch_spd_variants.py [VARIANT ...]

Each variant is ``recoder_tpu_torch/kernels/spd_solve.cu`` with text
patches applied; ``a+b`` applies both, and ``file=PATH+a`` applies ``a``
to another source (PATH from the repository root, e.g. a copy of an
earlier version under ``build/``). The variants:

  committed  the source as it is: panels of 16 columns, 128 threads a
             block, registers capped for 4 resident blocks an SM
  b3, b5     registers capped for 3 or 5 resident blocks (168 or 102 a
             thread)
  t256b3     256 threads a block, registers capped for 3 resident blocks
  no_load, no_panel, no_diagonal_tiles, no_factor, no_trailing, no_back
             the kernel without that phase (timed, not checked: the
             difference from ``committed`` is the phase's cost with the
             other blocks of the SM running)

For each variant it prints the ptxas registers and spill bytes of
``spd_solve_kernel``, its shared memory and resident blocks an SM at
d = 128, checks it against the blocked recursion with chip_smoke's
tolerances at every (B, d) of chip_smoke's phase 7 and at the iALS shape,
and times it at the iALS shape (B = 16,384, d = 128, systems built as
iALS builds them) by device time (torch.profiler sums), in turns: the
listed order, then the reverse. The variant sources and libraries go to
``build/spd_variants/`` (git-ignored), with the SASS of a variant whose
ptxas report shows a spill. The last line is a JSON object of the
results.
"""

import json
import os
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (the repository root, above)

SOURCE = os.path.join(ROOT, 'recoder_tpu_torch', 'kernels', 'spd_solve.cu')
OUT_DIR = os.path.join(ROOT, 'build', 'spd_variants')
DEFAULT = ('committed', 'b5', 'no_trailing', 'no_factor', 'no_load')
SHAPE = (16384, 128)

# (old, new) text pairs; each old text must occur exactly once
PATCHES = {
    'committed': [],
    'b3': [('constexpr int kMinBlocks = 4;', 'constexpr int kMinBlocks = 3;')],
    'b5': [('constexpr int kMinBlocks = 4;', 'constexpr int kMinBlocks = 5;')],
    't256b3': [('constexpr int kThreads = 128;',
                'constexpr int kThreads = 256;'),
               ('constexpr int kMinBlocks = 4;',
                'constexpr int kMinBlocks = 3;')],
    'no_load': [('          load_unit(l, as, bs, r, k, d, n, vec);\n', '')],
    'no_panel': [('      panel_solve(l, c0, n, tid);\n', '')],
    'no_diagonal_tiles': [('        update_diagonal(l, c0, lane);\n', '')],
    'no_factor': [('      factor_diagonal(l, c0 + kNB, lane, bad);\n', '')],
    'no_trailing': [('      update_trailing(l, c0, n, tid - 32);\n', '')],
    'no_back': [('  back_substitute(l, n, tid);\n', '')],
}


def slug(name):
  return re.sub(r'\W', '_', name)


def variant_source(name):
  parts = name.split('+')
  path = SOURCE
  if parts[0].startswith('file='):
    path = os.path.join(ROOT, parts.pop(0)[len('file='):])
  with open(path) as f:
    src = f.read()
  for part in parts:
    for old, new in PATCHES[part]:
      if src.count(old) != 1:
        raise ValueError(f'{part}: the patch does not apply once: {old!r}')
      src = src.replace(old, new)
  return src


def build(name):
  """(path of the library, compiler log) of one variant."""
  from recoder_tpu_torch import kernels
  stem = os.path.join(OUT_DIR, slug(name))
  with open(stem + '.cu', 'w') as f:
    f.write(variant_source(name))
  proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, '-o',
                         stem + '.so', stem + '.cu'], capture_output=True,
                        text=True)
  if proc.returncode != 0:
    raise RuntimeError(f'{name}: nvcc failed\n{proc.stdout}{proc.stderr}')
  return stem + '.so', proc.stdout + proc.stderr


def use(lib):
  """Patch the wrapper to load ``lib`` (a ctypes library) afresh."""
  from recoder_tpu_torch import kernels
  from recoder_tpu_torch.ops import spd
  spd._LIB = None
  return mock.patch.object(kernels, 'load_library', lambda name: lib)


def main(names):
  import ctypes

  from recoder_tpu_torch.ops import spd
  card = cs.phase_device()
  os.makedirs(OUT_DIR, exist_ok=True)
  with ThreadPoolExecutor(max_workers=len(names)) as pool:
    built = dict(zip(names, pool.map(build, names)))
  libs = {name: ctypes.CDLL(path) for name, (path, _) in built.items()}
  results = {}
  for name, (path, log) in built.items():
    frames = cs.ptxas_frames(log)
    spill = [v for f, v in frames.items() if 'spd_solve_kernel' in f]
    with use(libs[name]):
      res = spd.kernel_resources(SHAPE[1])
    results[name] = {'registers': cs.ptxas_registers(log),
                     'stack_spill_stores_loads': spill[0] if spill else None,
                     **res}
    if not spill or any(spill[0]):
      from torch.utils.cpp_extension import CUDA_HOME
      sass = subprocess.run([os.path.join(CUDA_HOME, 'bin', 'cuobjdump'),
                             '-sass', path], capture_output=True,
                            text=True).stdout
      with open(os.path.join(OUT_DIR, f'{slug(name)}.sass'), 'w') as f:
        f.write(sass)
    cs.say(f'{name}: {results[name]}')

  a, b = cs.ials_systems(*SHAPE, 'cuda')
  solves = [name for name in names
            if not any(p.startswith('no_') for p in name.split('+'))]
  for name in solves:
    with use(libs[name]):
      worst = cs.check_spd_ragged('cuda')
      err, scale, rel = cs.check_spd(a, b, f'{name} iALS shape')
    results[name].update(ragged_err=worst, ials_err=err / scale,
                         ials_residual=rel)
    cs.say(f'{name}: ragged worst err {worst:.3g} of max |x|; iALS shape '
           f'err {err / scale:.3g} of max |x|, residual {rel:.3g}')

  times = {name: [] for name in names}
  for name in list(names) + list(names)[::-1]:
    with use(libs[name]):
      times[name].append(cs.device_ms(lambda: spd.spd_solve_kernel(a, b),
                                      calls=10))
  for name in names:
    results[name]['ms'] = statistics.mean(times[name])
    cs.say(f'{name}: {results[name]["ms"]:.4f} ms device time at '
           f'{list(SHAPE)} (turns {times[name]})')
  cs.say(card)
  cs.say(json.dumps({'card': card, 'shape': SHAPE, 'variants': results}))


if __name__ == '__main__':
  main(tuple(sys.argv[1:]) or DEFAULT)
