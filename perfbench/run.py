"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics. The last line of standard
output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
``compared``: each number the correctness check compared, beside its
limit); the numbers compared are also the last lines of standard error.
The run exits non-zero and prints no result where CUDA is missing, where
the cell asks for more cards than there are, or where ``jax``,
``jaxlib``, ``flax`` or ``recoder_tpu`` was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, 'build', 'perfbench')


def main(argv=None):
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument('--workload', required=True)
  ap.add_argument('--seed', type=int, required=True)
  ap.add_argument('--seconds', type=float, required=True)
  ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
  args = ap.parse_args(argv)

  # every cache the run may fill sits at a fixed path in the checkout
  os.environ['TRITON_CACHE_DIR'] = os.path.join(CACHE, 'triton')
  os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(CACHE,
                                                    'torch_extensions')
  os.environ['USE_FLAX'] = '0'
  # (the checkout's root in place of this script's folder, whose module
  # names must not shadow the standard library's)
  sys.path[0] = ROOT
  from perfbench import harness

  cell = harness.load_cell(args.workload)
  import torch
  if not torch.cuda.is_available():
    print('no CUDA device: the benchmark measures the card', file=sys.stderr)
    return 1
  if torch.cuda.device_count() < cell['chips']:
    print(f'{args.workload} needs {cell["chips"]} cards, '
          f'{torch.cuda.device_count()} found', file=sys.stderr)
    return 1
  result = harness.run_cell(cell, args.seed, args.seconds, args.trace,
                            'cuda', T_START)
  found = harness.forbidden_modules()
  if found:
    print(f'forbidden modules loaded: {", ".join(found)}', file=sys.stderr)
    return 1
  for name, v in result['compared'].items():
    print(f'compared {name} {v["value"]!r} limit {v["limit"]!r}',
          file=sys.stderr)
  sys.stderr.flush()
  print(json.dumps(result), flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
