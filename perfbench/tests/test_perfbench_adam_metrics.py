"""The dense Adam layer's counter reader: ``adam_copy_share`` reads the
program's ``ops/adam.COPY_SHARE`` as a percentage, and nothing where the
counter holds no launch or the program has no such counter."""

import types

from perfbench import harness


def test_adam_copy_share_reads_the_programs_counter(monkeypatch):
  from recoder_tpu_torch.ops import adam
  reader = harness.load_reader('adam_copy_share')
  run = types.SimpleNamespace(slice=None, steps=0)
  monkeypatch.setitem(adam.COPY_SHARE, 'adam_bf16', 0.4979)
  assert reader.read(run) == 49.79
  monkeypatch.setitem(adam.COPY_SHARE, 'adam_bf16', None)
  assert reader.read(run) is None
  monkeypatch.delattr(adam, 'COPY_SHARE')  # (a program without it)
  assert reader.read(run) is None
