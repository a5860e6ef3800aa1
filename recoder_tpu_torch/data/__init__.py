"""Data: the CSR dataset, the host loader and the on-device training slab."""

from recoder_tpu_torch.data.dataset import (RecommendationDataset,
                                            UsersInteractions)
from recoder_tpu_torch.data.loader import (Batch, BatchCollator,
                                           RecommendationDataLoader)

__all__ = ['UsersInteractions', 'RecommendationDataset', 'Batch',
           'BatchCollator', 'RecommendationDataLoader']
