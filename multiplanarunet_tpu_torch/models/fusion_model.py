"""FusionModel: learned per-class-per-view linear fusion, in torch.

Port of `multiplanarunet_tpu/models/fusion_model.py`: for each voxel, with
per-view class probabilities x of shape (n_views, n_classes), predict
softmax(sum_v W[v] * x[v] + b), W initialised to 1 and b to 0, with the
mean-square regulariser `mp train_fusion` adds to its loss. Weights travel
as the JAX package's tree {"fusion": {"W": (V, C), "b": (1, C)}}, the one
`models.checkpoint.save_weights` / `load_weights` write and read.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


class FusionModel(nn.Module):
    def __init__(self, n_inputs, n_classes, params=None):
        """W = 1 and b = 0, or the values of a {"fusion": {"W", "b"}}
        tree."""
        super().__init__()
        self.n_inputs, self.n_classes = int(n_inputs), int(n_classes)
        self.W = nn.Parameter(torch.ones(n_inputs, n_classes))
        self.b = nn.Parameter(torch.zeros(1, n_classes))
        if params is not None:
            with torch.no_grad():
                for p, name in ((self.W, "W"), (self.b, "b")):
                    value = torch.as_tensor(
                        np.asarray(params["fusion"][name], np.float32))
                    if tuple(value.shape) != tuple(p.shape):
                        raise ValueError(
                            f"fusion/{name} has shape {tuple(value.shape)}; "
                            f"the model needs {tuple(p.shape)}")
                    p.copy_(value)

    def init_params(self, rng=None):
        """The initial weights as the JAX package's params tree,
        {"fusion": {"W": ones (V, C), "b": zeros (1, C)}} of float32
        numpy arrays. rng is unused: the initialisation is constant."""
        return {"fusion": {
            "W": np.ones((self.n_inputs, self.n_classes), np.float32),
            "b": np.zeros((1, self.n_classes), np.float32)}}

    def count_params(self, params=None):
        """The number of values of a params tree, or of this model's
        parameters when params is None."""
        if params is None:
            return sum(p.numel() for p in self.parameters())
        return sum(int(np.prod(np.shape(v)))
                   for v in params["fusion"].values())

    def forward(self, x):
        """x: (..., n_views, n_classes) -> (..., n_classes) probabilities."""
        return torch.softmax((self.W * x).sum(dim=-2) + self.b[0], dim=-1)

    def regularizer(self, weight=1e-6):
        """weight * mean(square(leaf)), summed over W then b (the JAX
        package's leaf order)."""
        return (weight * torch.mean(torch.square(self.W))
                + weight * torch.mean(torch.square(self.b)))


def params_tree(W, b):
    """{"fusion": {"W", "b"}} of float32 numpy copies of two tensors."""
    return {"fusion": {name: t.detach().to("cpu", torch.float32).numpy().copy()
                       for name, t in (("W", W), ("b", b))}}


def fuse_probabilities(params, view_probs):
    """Apply fusion weights ({"fusion": {"W", "b"}}, arrays or tensors) to
    a (..., n_views, n_classes) tensor."""
    W = torch.as_tensor(params["fusion"]["W"], device=view_probs.device)
    b = torch.as_tensor(params["fusion"]["b"], device=view_probs.device)
    return torch.softmax((W * view_probs).sum(dim=-2) + b[0], dim=-1)
