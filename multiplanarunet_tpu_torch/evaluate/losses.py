"""Segmentation losses over sparse integer targets, in torch.

Port of `multiplanarunet_tpu/evaluate/losses.py`. Every loss takes integer
class targets y_true ([B, ...spatial..., 1] or [B, ...spatial...]) and class
probabilities y_pred ([B, ...spatial..., n_classes], classes on the last
axis as in the JAX package). The one-hot target is made in y_pred's dtype,
per-class statistics reduce over the spatial axes of each batch element,
and the loss classes apply the sample weights and the mean reduction.
Probabilities are clipped to [1e-8, 1 - 1e-8] where a log is taken.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _one_hot_and_axes(y_true, y_pred):
    """(one-hot of y_true in y_pred's dtype and shape, spatial axes)."""
    n_classes = y_pred.shape[-1]
    if y_true.shape[-1] == 1 and y_true.dim() == y_pred.dim():
        y_true = y_true[..., 0]
    one_hot = torch.nn.functional.one_hot(y_true.long(), n_classes)
    return one_hot.to(y_pred.dtype), tuple(range(1, y_pred.dim() - 1))


def _clip(y_pred):
    return torch.clamp(y_pred, _EPS, 1.0 - _EPS)


# -------------------------------------------------------- per-element losses
def sparse_categorical_crossentropy(y_true, y_pred):
    one_hot, axes = _one_hot_and_axes(y_true, y_pred)
    ce = -torch.sum(one_hot * torch.log(_clip(y_pred)), dim=-1)
    return torch.mean(ce, dim=axes)


def sparse_dice_loss(y_true, y_pred, smooth=1.0):
    one_hot, axes = _one_hot_and_axes(y_true, y_pred)
    intersection = torch.sum(one_hot * y_pred, dim=axes)
    union = torch.sum(one_hot + y_pred, dim=axes)
    dice = (2.0 * intersection + smooth) / (union + smooth)
    return 1.0 - torch.mean(dice, dim=-1)


def sparse_jaccard_distance_loss(y_true, y_pred, smooth=1.0):
    one_hot, axes = _one_hot_and_axes(y_true, y_pred)
    intersection = torch.sum(one_hot * y_pred, dim=axes)
    total = torch.sum(one_hot + y_pred, dim=axes)
    jac = (intersection + smooth) / (total - intersection + smooth)
    return 1.0 - torch.mean(jac, dim=-1)


def sparse_exponential_logarithmic_loss(y_true, y_pred, gamma_dice=0.3,
                                        gamma_cross=0.3, weight_dice=1.0,
                                        weight_cross=1.0):
    """Wong et al. exp-log dice + exp cross-entropy."""
    one_hot, axes = _one_hot_and_axes(y_true, y_pred)
    y_pred = _clip(y_pred)
    intersect = 2.0 * torch.sum(one_hot * y_pred, dim=axes) + 1.0
    union = torch.sum(one_hot + y_pred, dim=axes) + 1.0
    exp_log_dice = torch.pow(-torch.log(intersect / union), gamma_dice)
    mean_exp_log_dice = torch.mean(exp_log_dice, dim=-1)
    entropy = torch.sum(one_hot * -torch.log(y_pred), dim=-1)
    exp_entropy = torch.mean(torch.pow(entropy, gamma_cross), dim=axes)
    return weight_dice * mean_exp_log_dice + weight_cross * exp_entropy


def sparse_focal_loss(y_true, y_pred, gamma=2.0, class_weights=None):
    one_hot, axes = _one_hot_and_axes(y_true, y_pred)
    y_pred = _clip(y_pred)
    if class_weights is None:
        class_weights = torch.ones(y_pred.shape[-1], dtype=y_pred.dtype,
                                   device=y_pred.device)
    else:
        class_weights = torch.as_tensor(class_weights, dtype=y_pred.dtype,
                                        device=y_pred.device)
    modulator = torch.pow(1.0 - y_pred, gamma)
    loss = -torch.sum(class_weights * one_hot * modulator * torch.log(y_pred),
                      dim=-1)
    return torch.mean(loss, dim=axes)


def sparse_generalized_dice_loss(y_true, y_pred, type_weight="Square"):
    """Sudre et al. generalized dice; weight types square/simple/uniform."""
    one_hot, axes = _one_hot_and_axes(y_true, y_pred)
    ref_vol = torch.sum(one_hot, dim=axes)
    intersect = torch.sum(one_hot * y_pred, dim=axes)
    seg_vol = torch.sum(y_pred, dim=axes)

    tw = type_weight.lower()
    if tw == "square":
        weights = 1.0 / torch.square(ref_vol)
    elif tw == "simple":
        weights = 1.0 / ref_vol
    elif tw == "uniform":
        weights = torch.ones_like(ref_vol)
    else:
        raise ValueError(f"Unknown type_weight '{type_weight}'")

    # Absent classes (inf weights) take the largest finite weight
    inf = torch.isinf(weights)
    finite_max = torch.where(inf, torch.zeros_like(weights), weights).max()
    weights = torch.where(inf, finite_max * torch.ones_like(weights), weights)

    numerator = 2.0 * weights * intersect
    denom = weights * (seg_vol + ref_vol) + 1e-6
    return 1.0 - torch.mean(numerator / denom, dim=-1)


# ------------------------------------------------------------------ reduction
class _LossWrapper:
    """Sample weights and the reduction around a per-element loss."""

    base_fn = None  # staticmethod in subclasses

    def __init__(self, reduction="sum_over_batch_size", **kwargs):
        self.reduction = reduction
        self.kwargs = {k: v for k, v in kwargs.items() if k != "name"}

    def element_loss(self, y_true, y_pred):
        return type(self).base_fn(y_true, y_pred, **self.kwargs)

    def __call__(self, y_true, y_pred, sample_weight=None):
        per_elem = self.element_loss(y_true, y_pred)
        if sample_weight is not None:
            per_elem = per_elem * torch.as_tensor(
                sample_weight, dtype=per_elem.dtype, device=per_elem.device)
        if self.reduction in (None, "none"):
            return per_elem
        return torch.mean(per_elem)

    def __repr__(self):
        return f"{type(self).__name__}(reduction={self.reduction}, " \
               f"{self.kwargs})"


def sparse_dice_ce_loss(y_true, y_pred, smooth_nr=0.0, smooth_dr=1e-6):
    """MONAI's DiceCELoss over probabilities (`squared_pred`): the sparse
    cross-entropy plus, per class (background included), 1 - (2 sum(p g)
    + smooth_nr) / (sum(p^2) + sum(g^2) + smooth_dr) over the spatial
    axes, the mean over the classes."""
    one_hot, axes = _one_hot_and_axes(y_true, y_pred)
    ce = -torch.sum(one_hot * torch.log(_clip(y_pred)), dim=-1)
    intersection = torch.sum(one_hot * y_pred, dim=axes)
    denom = torch.sum(y_pred * y_pred, dim=axes) + torch.sum(one_hot,
                                                             dim=axes)
    dice = 1.0 - (2.0 * intersection + smooth_nr) / (denom + smooth_dr)
    return torch.mean(ce, dim=axes) + torch.mean(dice, dim=-1)


class SparseCategoricalCrossentropy(_LossWrapper):
    base_fn = staticmethod(sparse_categorical_crossentropy)


class SparseDiceLoss(_LossWrapper):
    base_fn = staticmethod(sparse_dice_loss)


class SparseJaccardDistanceLoss(_LossWrapper):
    base_fn = staticmethod(sparse_jaccard_distance_loss)


class SparseExponentialLogarithmicLoss(_LossWrapper):
    base_fn = staticmethod(sparse_exponential_logarithmic_loss)


class SparseFocalLoss(_LossWrapper):
    base_fn = staticmethod(sparse_focal_loss)


class SparseGeneralizedDiceLoss(_LossWrapper):
    base_fn = staticmethod(sparse_generalized_dice_loss)


class SparseDiceCELoss(_LossWrapper):
    """The port's own (the JAX package has none): Swin UNETR's BTCV
    loss."""
    base_fn = staticmethod(sparse_dice_ce_loss)


SparseExpLogDice = SparseExponentialLogarithmicLoss

LOSSES = {
    cls.__name__: cls
    for cls in (
        SparseCategoricalCrossentropy,
        SparseDiceLoss,
        SparseJaccardDistanceLoss,
        SparseExponentialLogarithmicLoss,
        SparseFocalLoss,
        SparseGeneralizedDiceLoss,
        SparseDiceCELoss,
    )
}
LOSSES["SparseExpLogDice"] = SparseExpLogDice
