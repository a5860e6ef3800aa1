"""The port's entry points run on the card unless the caller asks for the
CPU: ``Recoder``, ``IALS`` and ``DeviceDataSource`` default to 'cuda'
and raise at construction when there is no card; nothing falls back to
the CPU."""

import inspect
from unittest import mock

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from recoder_tpu_torch import device as device_lib
from recoder_tpu_torch.data.device_pipeline import DeviceDataSource
from recoder_tpu_torch.model import Recoder
from recoder_tpu_torch.models import IALS, DynamicAutoencoder


def _matrix():
  rng = np.random.default_rng(0)
  return sp.csr_matrix((rng.random((12, 9)) < 0.3).astype(np.float32))


ENTRY_POINTS = {
    'Recoder': lambda **kw: Recoder(DynamicAutoencoder([4]), **kw),
    'IALS': lambda **kw: IALS(embedding_size=4, **kw),
    'DeviceDataSource': lambda **kw: DeviceDataSource(_matrix(), 4, 4, 9,
                                                      **kw),
}


@pytest.mark.parametrize('cls', [Recoder, IALS, DeviceDataSource])
def test_default_device_is_the_card(cls):
  default = inspect.signature(cls).parameters['device'].default
  assert default == device_lib.DEFAULT == 'cuda'


@pytest.mark.parametrize('name', sorted(ENTRY_POINTS))
def test_without_a_card_the_default_raises(name):
  with mock.patch.object(torch.cuda, 'is_available', return_value=False):
    with pytest.raises(RuntimeError, match="device='cpu'"):
      ENTRY_POINTS[name]()
    with pytest.raises(RuntimeError, match='CUDA is not available'):
      ENTRY_POINTS[name](device='cuda:0')
    assert ENTRY_POINTS[name](device='cpu').device == torch.device('cpu')
