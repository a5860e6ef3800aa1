"""Data: the CSR dataset and the on-device training slab."""

from recoder_tpu_torch.data.dataset import (RecommendationDataset,
                                            UsersInteractions)

__all__ = ['RecommendationDataset', 'UsersInteractions']
