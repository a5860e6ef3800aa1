"""Factorization models (``recoder_tpu/models``): the SGD-trained
DynamicAutoencoder, MatrixFactorization and MultVAE, which ``Recoder``
trains, and the closed-form EASE and iALS, which fit themselves."""

from recoder_tpu_torch.models.autoencoder import DynamicAutoencoder
from recoder_tpu_torch.models.base import FactorizationModel, activation
from recoder_tpu_torch.models.ease import EASE
from recoder_tpu_torch.models.ials import IALS
from recoder_tpu_torch.models.matrix_factorization import MatrixFactorization
from recoder_tpu_torch.models.multvae import MultVAE

__all__ = ['FactorizationModel', 'activation', 'DynamicAutoencoder',
           'MatrixFactorization', 'EASE', 'IALS', 'MultVAE']
