"""Factorization models."""

from recoder_tpu_torch.models.autoencoder import DynamicAutoencoder
from recoder_tpu_torch.models.base import FactorizationModel
from recoder_tpu_torch.models.ials import IALS

__all__ = ['DynamicAutoencoder', 'FactorizationModel', 'IALS']
