"""Where the port's entry points run.

``Recoder``, ``IALS`` and ``DeviceDataSource`` run on the card unless the
caller asks for the CPU (``device='cpu'``, as the CPU tests do). A CUDA
device that is not there raises at construction; nothing falls back to
the CPU.
"""

import torch

#: the entry points' default device
DEFAULT = 'cuda'


def resolve(device):
  """``torch.device(device)``, refusing a CUDA device without a card."""
  device = torch.device(device)
  if device.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError(f'device {device} was asked for but CUDA is not '
                       "available; pass device='cpu' to run on the CPU")
  return device
