"""The hand kernels' one binding (``kernels.Library``): on a stand-in
library, a source loads once per name, the table's argument types are
applied, a nonzero error code raises with the call's name and the
library's text for it and a zero one passes; and each wrapper's table
names functions of its source with the source's argument types."""

import ctypes
import importlib
import os
import re
import subprocess

import pytest

from recoder_tpu_torch import kernels
from recoder_tpu_torch.kernels import F32, I32, I64, PTR

ERRORS = {3: b'invalid argument'}


class FakeLibrary:
  """A loaded library's stand-in: ``fk_launch(ptr, code)`` returns
  ``code`` and ``fk_width()`` 7, each a ctypes function (so that the
  binding's argument types and error check apply to its calls)."""

  def __init__(self, path):
    self._name = path
    self.fk_launch = ctypes.CFUNCTYPE(I32, PTR, I32)(lambda ptr, code: code)
    self.fk_width = ctypes.CFUNCTYPE(I32)(lambda: 7)

  @staticmethod
  def fk_error_string(err):
    return ERRORS[err]


def test_a_library_is_loaded_and_bound_once(monkeypatch, tmp_path):
  (tmp_path / 'fake.cu').write_text('// a source')
  monkeypatch.setattr(kernels, '_HERE', str(tmp_path))
  monkeypatch.setattr(kernels, 'BUILD_DIR', str(tmp_path / 'build'))
  monkeypatch.setattr(kernels, '_nvcc', lambda: 'nvcc')
  monkeypatch.setattr(kernels, '_LIBS', {})
  loads = []

  def cdll(path):
    loads.append(path)
    return FakeLibrary(path)

  def nvcc(cmd, **kw):
    with open(cmd[cmd.index('-o') + 1], 'w') as f:
      f.write('built')
    return subprocess.CompletedProcess(cmd, 0, '', '')
  monkeypatch.setattr(kernels.ctypes, 'CDLL', cdll)
  monkeypatch.setattr(kernels.subprocess, 'run', nvcc)
  widths = []
  library = kernels.Library(
      'fake', 'fk', {'fk_launch': ([PTR, I32], 'fake launch'),
                     'fk_width': ([], None)},
      constants=lambda lib: widths.append(lib.fk_width()))

  lib = library()
  assert library() is lib
  assert kernels.Library('fake', 'fk', {})() is lib
  assert len(loads) == 1 and widths == [7]
  assert lib.fk_launch.argtypes == [PTR, I32]
  assert lib.fk_launch.restype is I32 and lib.fk_width.argtypes == []
  assert lib.fk_error_string.argtypes == [I32]
  assert lib.fk_error_string.restype is ctypes.c_char_p
  with pytest.raises(ctypes.ArgumentError):
    lib.fk_launch(None, 'three')
  assert lib.fk_launch(None, 0) == 0
  with pytest.raises(RuntimeError, match=r'^fake launch failed: CUDA error '
                     r'3 \(invalid argument\)$'):
    lib.fk_launch(None, 3)
  # (a value, not an error code: never raises)
  assert lib.fk_width() == 7


#: a C parameter's type (its declaration less the name) -> ctypes'
C_TYPES = {'int': I32, 'long long': I64, 'float': F32}


def _c_signatures(name):
  """``{function: [C parameter types]}`` of ``kernels/<name>.cu``'s
  functions that return ``int``."""
  with open(os.path.join(os.path.dirname(kernels.__file__),
                         f'{name}.cu')) as f:
    source = f.read()
  return {m[1]: [' '.join(p.split()[:-1]) for p in m[2].split(',')
                 if p.strip()]
          for m in re.finditer(r'^int\s+(\w+)\s*\(([^)]*)\)\s*\{', source,
                               re.M)}


@pytest.mark.parametrize('module', ['adam', 'fused_decode_loss',
                                    'multinomial_loss', 'noised_input',
                                    'packed_rows', 'row_scatter', 'spd'])
def test_a_wrappers_table_matches_its_source(module):
  library = importlib.import_module(f'recoder_tpu_torch.ops.{module}').LIBRARY
  signatures = _c_signatures(library.name)
  assert library.functions
  for fname, (argtypes, _) in library.functions.items():
    assert fname.startswith(library.prefix + '_')
    params = signatures[fname]
    assert len(argtypes) == len(params), fname
    for t, c in zip(argtypes, params):
      if c.endswith('*'):
        assert t is PTR or issubclass(t, ctypes._Pointer), (fname, c)
      else:
        assert t is C_TYPES[c], (fname, c)
