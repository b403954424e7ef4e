"""FusionModel: learned per-class-per-view linear fusion, in torch.

Port of `multiplanarunet_tpu/models/fusion_model.py`: for each voxel, with
per-view class probabilities x of shape (n_views, n_classes), predict
softmax(sum_v W[v] * x[v] + b), W initialised to 1 and b to 0.
"""

from __future__ import annotations

import torch
from torch import nn


class FusionModel(nn.Module):
    def __init__(self, n_inputs, n_classes):
        super().__init__()
        self.W = nn.Parameter(torch.ones(n_inputs, n_classes))
        self.b = nn.Parameter(torch.zeros(1, n_classes))

    def forward(self, x):
        """x: (..., n_views, n_classes) -> (..., n_classes) probabilities."""
        return torch.softmax((self.W * x).sum(dim=-2) + self.b[0], dim=-1)


def fuse_probabilities(params, view_probs):
    """Apply fusion weights ({"fusion": {"W", "b"}}, arrays or tensors) to
    a (..., n_views, n_classes) tensor."""
    W = torch.as_tensor(params["fusion"]["W"], device=view_probs.device)
    b = torch.as_tensor(params["fusion"]["b"], device=view_probs.device)
    return torch.softmax((W * view_probs).sum(dim=-2) + b[0], dim=-1)
