"""The U-Net, in torch, for inference and training, over 2D slices or 3D
boxes.

Port of `multiplanarunet_tpu/models/unet.py:UNet` at the same topology:
a depth-N encoder of [conv k^n SAME -> act] x2 -> BatchNorm -> maxpool
2^n, a bottom block, and a decoder of [nearest 2x upsample -> conv 2^n
SAME -> act -> BatchNorm -> crop skip to match -> concat [skip, up] ->
ConvBN block], then a float32 1^n out conv and the output activation.
Filters are int(init_filters * 2^i * sqrt(complexity_factor)).
kernel_size, activation and out_activation follow the JAX model's fields;
an activation name the port does not know raises
`UnsupportedActivationError` rather than computing something else. The
building blocks take the spatial rank n (`ndim`): `UNet` is the 2D model
(NCHW), `models/unet3d.py:UNet3D` the 3D one (NCDHW) on the same blocks.

Parameters and BatchNorm statistics stay float32; the convolutions run in
`dtype` (bf16 on the card), as the JAX model's `dtype` does, and BatchNorm
normalises in float32 (eps 1e-3). In eval mode BatchNorm uses the running
statistics; in train mode (`.train()`) it normalises with the batch
statistics and updates the running ones as flax does: float32 reductions,
the biased variance max(0, E[x^2] - E[x]^2), running = 0.99 * running +
0.01 * batch. While a process group is active (data-parallel training,
`parallel.distributed`), the batch statistics are those of the global batch
over every rank, as the JAX package's sharded step computes them, so every
rank keeps the same running statistics. Weights come from the JAX package's
checkpoints through `models.checkpoint`, or from `glorot_init`
(glorot-uniform kernels of every conv rank, zero biases, the JAX model's
init). `label_crop` holds the (n, 2) skip crops of the last forward, the
JAX model's sown `label_crop` (zero when the input side is divisible by
2^depth).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from multiplanarunet_tpu_torch.parallel.distributed import data_group_active


class UnsupportedActivationError(ValueError):
    """An activation name with no counterpart in the port."""


def _identity(x):
    return x


# flax.linen / jax.nn activation names -> torch (flax's gelu is the tanh
# approximation; leaky_relu's default slope is 0.01 in both)
_ACTIVATIONS = {
    "relu": F.relu,
    "elu": F.elu,
    "selu": F.selu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "silu": F.silu,
    "swish": F.silu,
    "softplus": F.softplus,
    "leaky_relu": F.leaky_relu,
    "linear": _identity,
    None: _identity,
}


def get_activation(name):
    """The torch function of a JAX-package activation name."""
    if name not in _ACTIVATIONS:
        raise UnsupportedActivationError(
            f"Activation {name!r} is not available in the PyTorch port "
            f"(supported: {sorted(k for k in _ACTIVATIONS if k)})")
    return _ACTIVATIONS[name]


def output_activation(name):
    """The out activation over NCHW logits: softmax over the class axis,
    else an elementwise activation."""
    if name == "softmax":
        return lambda x: torch.softmax(x, dim=1)
    return get_activation(name)


class _CastConv:
    """Conv with float32 parameters that computes in the input's dtype."""

    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype),
                                  self.bias.to(x.dtype))


class Conv2d(_CastConv, nn.Conv2d):
    pass


class Conv3d(_CastConv, nn.Conv3d):
    pass


CONV = {2: Conv2d, 3: Conv3d}


# Keras / flax BatchNorm momentum: running = m * running + (1 - m) * batch
BN_MOMENTUM = 0.99


class _BatchStatsNorm(torch.autograd.Function):
    """BatchNorm over the batch's statistics as flax computes them: float32
    reductions, the biased variance max(0, E[x^2] - E[x]^2). The forward
    normalises with those statistics in one fused F.batch_norm (float32
    arithmetic, output in the input's dtype); the backward is aten's batch
    norm backward at the same mean and 1/std, the gradient of that same
    function. Returns (y, mean, var); mean and var carry no gradient.

    With `data_parallel` (a process group is active) the statistics are
    those of the global batch: the per-channel float32 sum, sum of squares
    and count are all-reduced (in float64) before the mean and variance
    are taken, and the backward all-reduces sum(dy) and sum(dy * x_hat)
    per channel and forms dx from their global means, as the gradient of
    the mean loss over every rank's rows needs. The parameter gradients
    stay local sums, which DistributedDataParallel averages. Both use
    only all_reduce."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, data_parallel=False):
        xf = x.float()
        dims = (0,) + tuple(range(2, x.dim()))  # all but the channel axis
        ctx.data_parallel = data_parallel
        if data_parallel:
            c = x.shape[1]
            stats = torch.cat([xf.sum(dim=dims), (xf * xf).sum(dim=dims),
                               xf.new_full((1,), xf.numel() // c)]).double()
            dist.all_reduce(stats)
            n = stats[-1]
            mean = (stats[:c] / n).float()
            var = torch.clamp((stats[c:2 * c] / n).float() - mean * mean,
                              min=0.0)
            ctx.count = n
        else:
            mean = xf.mean(dim=dims)
            var = torch.clamp((xf * xf).mean(dim=dims) - mean * mean,
                              min=0.0)
        del xf
        y = F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps)
        ctx.save_for_backward(x, weight, mean, torch.rsqrt(var + eps))
        ctx.eps = eps
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, grad_y, _grad_mean, _grad_var):
        x, weight, mean, invstd = ctx.saved_tensors
        if not ctx.data_parallel:
            grad_x, grad_w, grad_b = \
                torch.ops.aten.native_batch_norm_backward(
                    grad_y.contiguous(), x, weight, None, None, mean, invstd,
                    True, ctx.eps, [True, True, True])
            return grad_x, grad_w, grad_b, None, None
        dims = (0,) + tuple(range(2, x.dim()))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        g = grad_y.float()
        x_hat = (x.float() - mean.view(shape)) * invstd.view(shape)
        grad_b = g.sum(dim=dims)
        grad_w = (g * x_hat).sum(dim=dims)
        c = grad_b.shape[0]
        sums = torch.cat([grad_b, grad_w]).double()
        dist.all_reduce(sums)
        sums = (sums / ctx.count).float()
        grad_x = (weight * invstd).view(shape) * (
            g - sums[:c].view(shape) - x_hat * sums[c:].view(shape))
        return grad_x.to(x.dtype), grad_w, grad_b, None, None


class _FlaxBatchNorm:
    """BatchNorm (Keras eps 1e-3) normalising in float32 and returning the
    input's dtype. Eval mode uses the running statistics. Train mode
    normalises with the batch's statistics and updates the running ones
    from them, as flax does: 0.99 * running + 0.01 * batch, with the
    biased variance (F.batch_norm's own running update, with the unbiased
    variance, is never used). Under an active process group the batch's
    statistics are the global batch's (`_BatchStatsNorm`)."""

    def __init__(self, channels):
        super().__init__(channels, eps=1e-3, momentum=1.0 - BN_MOMENTUM)

    def forward(self, x):
        if not self.training:
            y = F.batch_norm(x.float(), self.running_mean, self.running_var,
                             self.weight, self.bias, False, 0.0, self.eps)
            return y.to(x.dtype)
        y, mean, var = _BatchStatsNorm.apply(x, self.weight, self.bias,
                                             self.eps, data_group_active())
        with torch.no_grad():
            m = BN_MOMENTUM
            self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        return y


class BatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    pass


class BatchNorm3d(_FlaxBatchNorm, nn.BatchNorm3d):
    pass


BATCH_NORM = {2: BatchNorm2d, 3: BatchNorm3d}
MAX_POOL = {2: F.max_pool2d, 3: F.max_pool3d}


class ConvBNBlock(nn.Module):
    """Two k^n SAME convs with the activation, then BatchNorm (n = ndim
    spatial axes)."""

    def __init__(self, in_channels, filters, kernel_size, act, ndim=2):
        super().__init__()
        conv = CONV[ndim]
        self.conv1 = conv(in_channels, filters, kernel_size, padding="same")
        self.conv2 = conv(filters, filters, kernel_size, padding="same")
        self.bn = BATCH_NORM[ndim](filters)
        self.act = act

    def forward(self, x):
        x = self.act(self.conv1(x))
        x = self.act(self.conv2(x))
        return self.bn(x)


def crop_to_match(skip, up):
    """Center-crop `skip`'s spatial dims (channels first, any number of
    them) down to `up`'s. Returns (cropped, crops) with crops the (n, 2)
    (lo, hi) voxel crops of the n spatial axes."""
    diff = np.array(skip.shape[2:]) - np.array(up.shape[2:])
    if np.all(diff == 0):
        return skip, np.zeros((len(diff), 2), np.int64)
    lo = diff // 2
    hi = diff - lo
    cropped = skip[(slice(None), slice(None)) + tuple(
        slice(l, n - h) for l, h, n in zip(lo, hi, skip.shape[2:]))]
    return cropped, np.stack([lo, hi], axis=1).astype(np.int64)


class UNet(nn.Module):
    """Configurable-depth U-Net with complexity scaling over `ndim`
    spatial axes (2 here; `UNet3D` sets 3).

    forward: (B, n_channels, *spatial) -> (B, n_classes, *spatial')
    float32 outputs of out_activation (probabilities for the default
    softmax)."""

    ndim = 2

    def __init__(self, n_classes, n_channels=1, depth=4, complexity_factor=1.0,
                 init_filters=64, kernel_size=3, activation="relu",
                 out_activation="softmax", dtype=torch.float32):
        super().__init__()
        self.n_classes = int(n_classes)
        self.n_channels = int(n_channels)
        self.depth = int(depth)
        self.complexity_factor = float(complexity_factor)
        self.dtype = dtype
        self.act = get_activation(activation)
        self.out_act = output_activation(out_activation)
        cf = self.cf
        k = self.kernel_size = int(kernel_size)

        n = self.ndim
        cin, filters = self.n_channels, init_filters
        for i in range(self.depth):
            f = int(filters * cf)
            self.add_module(f"encoder_L{i}",
                            ConvBNBlock(cin, f, k, self.act, n))
            cin, filters = f, filters * 2
        f = int(filters * cf)
        self.bottom = ConvBNBlock(cin, f, k, self.act, n)
        cin = f
        for i in range(self.depth):
            filters //= 2
            f = int(filters * cf)
            # 2^n SAME conv after the upsample: SAME pads an even kernel
            # (0, 1), the high edge of every axis only (done in forward)
            self.add_module(f"decoder_L{i}_conv_up", CONV[n](cin, f, 2))
            self.add_module(f"decoder_L{i}_bn_up", BATCH_NORM[n](f))
            self.add_module(f"decoder_L{i}",
                            ConvBNBlock(2 * f, f, k, self.act, n))
            cin = f
        self.out_conv = (nn.Conv2d if n == 2 else nn.Conv3d)(
            cin, self.n_classes, 1)
        self.label_crop = np.zeros((n, 2), np.int64)

    @property
    def cf(self):
        """sqrt(complexity_factor), the filter multiplier."""
        return float(np.sqrt(self.complexity_factor))

    def forward(self, x):
        x = x.to(self.dtype)
        n = self.ndim
        skips = []
        for i in range(self.depth):
            x = getattr(self, f"encoder_L{i}")(x)
            skips.append(x)
            x = MAX_POOL[n](x, 2, 2)
        x = self.bottom(x)
        label_crop = np.zeros((n, 2), np.int64)
        for i in range(self.depth):
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = getattr(self, f"decoder_L{i}_conv_up")(F.pad(x, (0, 1) * n))
            x = getattr(self, f"decoder_L{i}_bn_up")(self.act(x))
            skip, crops = crop_to_match(skips[-(i + 1)], x)
            label_crop += crops
            x = getattr(self, f"decoder_L{i}")(torch.cat([skip, x], dim=1))
        self.label_crop = label_crop
        # The out conv runs in float32 whatever the compute dtype
        return self.out_act(self.out_conv(x.float()))

    @property
    def receptive_field(self):
        """Receptive field of the deepest encoder feature (conv
        arithmetic)."""
        from multiplanarunet_tpu_torch.utils.conv_arithmetics import (
            unet_encoder_receptive_field,
        )

        return unet_encoder_receptive_field(self.depth, self.kernel_size)

    def count_params(self):
        return count_params(self)


def count_params(model):
    """The number of parameter values of `model` (BatchNorm running
    statistics not counted), the count the JAX models take over their
    params tree."""
    return sum(p.numel() for p in model.parameters())


def glorot_init(model, seed=0):
    """Initialise `model` in place as the JAX U-Nets initialise: every
    conv kernel of any rank glorot-uniform (fan_in = k^n * cin, fan_out =
    k^n * cout), biases zero, every BatchNorm at scale 1 / bias 0 / mean
    0 / var 1. Draws come from a CPU torch.Generator seeded with `seed`,
    in module order."""
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.modules.conv._ConvNd):
                w = torch.empty(mod.weight.shape, dtype=torch.float32)
                nn.init.xavier_uniform_(w, generator=gen)
                mod.weight.copy_(w)
                mod.bias.zero_()
            elif isinstance(mod, nn.modules.batchnorm._BatchNorm):
                mod.reset_parameters()
    return model
