"""Puts the checkout's root on the import path, keeps each test process
to two CPU threads (parallel workers would otherwise oversubscribe the
cores many times over), and gives the card tests their fixture: a test
marked ``cuda`` asks for ``card``, which skips it where there is no CUDA
device (decided when the test runs, never at import or collection)."""

import os
import sys

import pytest
import torch

torch.set_num_threads(2)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


@pytest.fixture
def card():
  import torch
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device')
  return torch.device('cuda')
