"""Factorization models."""

from recoder_tpu_torch.models.autoencoder import DynamicAutoencoder
from recoder_tpu_torch.models.base import FactorizationModel

__all__ = ['DynamicAutoencoder', 'FactorizationModel']
