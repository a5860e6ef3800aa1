"""Build and load the port's hand-written CUDA kernels.

Each ``<name>.cu`` in this directory has a plain C interface. At first
use it is compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared
library under ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``) and loaded with ``ctypes``; callers pass raw device
pointers (``tensor.data_ptr()``) and PyTorch's current stream. The
library name carries a hash of the source and the flags, so an edited
source is rebuilt and a stale library is never loaded. The compiler
writes to a temporary file that is moved into place with ``os.replace``,
so a process never loads a half-written library.

Each source has a lock of its own, so two sources build at once when
two threads ask for them. ``EXTRA_FLAGS`` adds flags for one source:
``adam.cu`` builds with ``-fmad=false``, so that its arithmetic is the
plain version's, operation for operation.

Each wrapper counts its launches (:func:`count_launch`). A launch that
a CUDA graph capture records is not run then, and the graph's replays
run it without Python: neither is counted, so a profile of the replays
is what counts the kernels of a captured step.

Nothing here runs at import time: the CPU tests import every module,
and a machine without a card need not have ``nvcc``.
"""

import ctypes
import hashlib
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), 'build',
                         'kernels')
NVCC_FLAGS = ('-gencode=arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
EXTRA_FLAGS = {'adam': ('-fmad=false',)}

_LOCK = threading.Lock()
_NAME_LOCKS = {}
_LIBS = {}
#: name -> the compiler's output (ptxas register / shared-memory report)
BUILD_LOGS = {}


def capturing():
  """Whether the current CUDA stream is recording a graph."""
  import torch
  return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def count_launch(counts, name):
  """Add one to ``counts[name]`` unless the current stream is capturing."""
  if not capturing():
    counts[name] += 1


def _nvcc():
  from torch.utils.cpp_extension import CUDA_HOME
  if CUDA_HOME is None:
    raise RuntimeError('building the CUDA kernels needs the CUDA toolkit '
                       '(nvcc); none was found')
  return os.path.join(CUDA_HOME, 'bin', 'nvcc')


def load_library(name):
  """Build (once per process and source) and load ``<name>.cu``."""
  with _LOCK:
    lock = _NAME_LOCKS.setdefault(name, threading.Lock())
  with lock:
    lib = _LIBS.get(name)
    if lib is not None:
      return lib
    src = os.path.join(_HERE, f'{name}.cu')
    flags = NVCC_FLAGS + EXTRA_FLAGS.get(name, ())
    with open(src, 'rb') as f:
      digest = hashlib.sha1(f.read() + ' '.join(flags).encode())
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f'{name}-{digest.hexdigest()[:12]}.so')
    log_path = out[:-3] + '.log'
    if not os.path.exists(out):
      tmp = f'{out}.build.{os.getpid()}'
      cmd = [_nvcc(), *flags, '-o', tmp, src]
      proc = subprocess.run(cmd, capture_output=True, text=True)
      if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed building {name}.cu:\n'
                           f'{proc.stdout}{proc.stderr}')
      with open(log_path, 'w') as f:
        f.write(proc.stdout + proc.stderr)
      os.replace(tmp, out)
    if os.path.exists(log_path):
      with open(log_path) as f:
        BUILD_LOGS[name] = f.read()
    lib = ctypes.CDLL(out)
    _LIBS[name] = lib
    return lib

