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
checkpoints through `models.checkpoint`, or from `glorot_init`, which
gives the weights the JAX package's flax init gives from the same
PRNGKey, bit for bit (`init_unet`). `label_crop` holds the (n, 2) skip
crops of the last forward, the JAX model's sown `label_crop` (zero when
the input side is divisible by 2^depth).

The JAX model's inference forms are fields here too, each computing the
same function with the same parameters (so a checkpoint loads into any
of them): `dilated_upconv` computes the decoder's upsample + 2^n conv as
one transposed conv with a 3^n kernel (`DilatedUpConv`),
`subpixel_decoder` as 2^n parity convs on the source grid
(`SubpixelUpConv`), `predict_fused_bn` makes eval-mode BatchNorm one
multiply-add in the compute dtype (`FusedBNAffine`), `predict_skip_bn`
drops eval-mode BatchNorm (a probe, not the same function), and
`lane_pad` rounds every internal filter count up to a multiple, exact
with the zero embedding of `lane_pad_variables`. The 2D `UNet` takes all
five, `UNet3D` the two decoder forms, as in the JAX package.
"""

from __future__ import annotations

import hashlib
import inspect

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from multiplanarunet_tpu_torch._device import resolve_device
from multiplanarunet_tpu_torch.models import checkpoint
from multiplanarunet_tpu_torch.ops import prng
from multiplanarunet_tpu_torch.parallel.distributed import data_group_active


class UnsupportedActivationError(ValueError):
    """An activation name with no counterpart in the port."""


def _identity(x):
    return x


def _softplus(x):
    """jax.nn.softplus: logaddexp(x, 0)."""
    return torch.logaddexp(x, x.new_zeros(()))


def _relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def _hard_sigmoid(x):
    return _relu6(x + 3.0) / 6.0


def _hard_silu(x):
    return x * _hard_sigmoid(x)


def _standardize(x):
    """jax.nn.standardize over the channel axis: the variance as
    E[x^2] - E[x]^2 clipped at 0, epsilon 1e-5."""
    mean = x.mean(dim=1, keepdim=True)
    var = torch.clamp_min((x * x).mean(dim=1, keepdim=True) - mean * mean,
                          0.0)
    return (x - mean) * torch.rsqrt(var + 1e-5)


# flax.linen / jax.nn activation names -> torch, each in the jax source's
# form and constants (flax's gelu is the tanh approximation; leaky_relu's
# slope is 0.01, celu's alpha 1, squareplus's b 4). The JAX models apply
# softmax, log_softmax, standardize and normalize (flax's name for
# standardize) over the last axis of NHWC; here over the channel axis,
# dim 1 of NCHW and NCDHW.
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
    "identity": _identity,
    None: _identity,
    "celu": lambda x: (torch.clamp_min(x, 0.0)
                       + torch.expm1(torch.clamp_max(x, 0.0))),
    "relu6": _relu6,
    "hard_sigmoid": _hard_sigmoid,
    "hard_silu": _hard_silu,
    "hard_swish": _hard_silu,
    "hard_tanh": lambda x: torch.clamp(x, -1.0, 1.0),
    "log1mexp": lambda x: torch.where(x < float(np.log(np.float32(2.0))),
                                      torch.log(-torch.expm1(-x)),
                                      torch.log1p(-torch.exp(-x))),
    "log_sigmoid": lambda x: -_softplus(-x),
    "mish": lambda x: x * torch.tanh(_softplus(x)),
    "soft_sign": lambda x: x / (torch.abs(x) + 1.0),
    "sparse_plus": lambda x: torch.where(
        x <= -1.0, 0.0, torch.where(x >= 1.0, x, (x + 1.0) ** 2 / 4.0)),
    "sparse_sigmoid": lambda x: 0.5 * torch.clamp(x + 1.0, 0.0, 2.0),
    "squareplus": lambda x: (x + torch.sqrt(x * x + 4.0)) / 2.0,
    "softmax": lambda x: torch.softmax(x, dim=1),
    "log_softmax": lambda x: torch.log_softmax(x, dim=1),
    "standardize": _standardize,
    "normalize": _standardize,
}

# Names `getattr(flax.linen, name)` resolves in the JAX package that are
# not activations: decorators and boxing helpers that return an array
# unchanged only by accident. The port refuses them.
NOT_ACTIVATIONS = {
    "add_metadata_axis": "a decorator factory for a module's "
                         "partitioning metadata",
    "combine_masks": "combines attention masks (a None-filtering helper)",
    "compact": "the module-method decorator",
    "nowrap": "the module-method decorator that skips wrapping",
    "unbox": "unboxes partitioned parameter metadata",
}


def get_activation(name):
    """The torch function of a JAX-package activation name (the hidden and
    the out activation alike)."""
    if name not in _ACTIVATIONS:
        why = (f": {NOT_ACTIVATIONS[name]}, not an activation"
               if name in NOT_ACTIVATIONS else "")
        raise UnsupportedActivationError(
            f"Activation {name!r} is not available in the PyTorch port"
            f"{why} (supported: {sorted(k for k in _ACTIVATIONS if k)})")
    return _ACTIVATIONS[name]


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


class FusedBNAffine(_FlaxBatchNorm, nn.modules.batchnorm._BatchNorm):
    """BatchNorm whose eval mode is one multiply-add in the compute
    dtype: ``x * a + b`` with ``a = scale * rsqrt(var + eps)`` and
    ``b = bias - mean * a`` computed in float32 and cast to x's dtype, as
    `multiplanarunet_tpu/models/unet.py:FusedBNAffine` computes it. Any
    spatial rank. The parameters and buffers are BatchNorm's (weight,
    bias, running_mean, running_var), so a checkpoint loads into either.
    Train mode is the flax BatchNorm of `BatchNorm2d` / `BatchNorm3d`.
    In bf16 it differs from the float32 normalisation by the rounding of
    (a, b)."""

    def forward(self, x):
        if self.training:
            return super().forward(x)
        a = self.weight * torch.rsqrt(self.running_var + self.eps)
        b = self.bias - self.running_mean * a
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return x * a.to(x.dtype).view(shape) + b.to(x.dtype).view(shape)


def _batch_norm(channels, ndim=2, fused=False):
    """The BatchNorm of rank `ndim`, or a `FusedBNAffine`."""
    return FusedBNAffine(channels) if fused else BATCH_NORM[ndim](channels)


class ConvBNBlock(nn.Module):
    """Two k^n SAME convs with the activation, then BatchNorm (n = ndim
    spatial axes). In eval mode, `fused_bn` runs the BatchNorm as a
    `FusedBNAffine` and `skip_bn` leaves it out, as the JAX block's
    fields do."""

    def __init__(self, in_channels, filters, kernel_size, act, ndim=2,
                 fused_bn=False, skip_bn=False):
        super().__init__()
        conv = CONV[ndim]
        self.conv1 = conv(in_channels, filters, kernel_size, padding="same")
        self.conv2 = conv(filters, filters, kernel_size, padding="same")
        self.bn = _batch_norm(filters, ndim, fused_bn)
        self.act = act
        self.skip_bn = skip_bn

    def forward(self, x):
        x = self.act(self.conv1(x))
        x = self.act(self.conv2(x))
        if self.skip_bn and not self.training:
            return x
        return self.bn(x)


def upsample2x(x):
    """Nearest 2x upsample over every spatial axis of a channels-first
    tensor (each voxel repeated 2^n times, Keras' UpSampling)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class _UpConv(nn.modules.conv._ConvNd):
    """The parameters of the decoder's up conv as the plain 2^n conv
    holds them: an (O, I, 2, .., 2) float32 kernel and a bias. So
    checkpoints, `glorot_init` (fan_in 2^n * I) and by-name restores treat
    the forms below as that conv. Subclasses compute upsample2x -> the
    2^n conv SAME-padded (0, 1) from the source tensor, in its dtype."""

    def __init__(self, in_channels, filters, ndim=2):
        one, zero = (1,) * ndim, (0,) * ndim
        super().__init__(in_channels, filters, (2,) * ndim, one, zero, one,
                         False, zero, 1, True, "zeros")
        self.ndim = ndim


class DilatedUpConv(_UpConv):
    """upsample2x -> conv 2^n SAME as one transposed conv: nearest-up(x)
    is x dilated by 2 convolved with ones(2^n), so up-then-conv_k is the
    dilated x correlated with the 3^n kernel ``K[m, n] = sum_{a, b}
    A[a, m] A[b, n] k[a, b]``, ``A = [[1, 1, 0], [0, 1, 1]]``
    (`multiplanarunet_tpu/models/unet.py:DilatedUpConv`). The JAX model
    feeds the dilation to the conv (`lhs_dilation`); torch would have to
    build the zero-inserted tensor, so the port computes the same function
    as a stride-2 transposed conv with the flipped K, padding 1 and output
    padding 1. Neither the 2^n-times larger upsampled tensor nor the
    dilated one is ever stored, and each output voxel takes 2.25 (2D) or
    3.375 (3D) taps on average in place of 2^n."""

    def forward(self, x):
        n = self.ndim
        # Along each spatial axis K = (k0, k0 + k1, k1); the transposed
        # conv takes it flipped, (k1, k0 + k1, k0), and (in, out) first
        K = self.weight
        for ax in range(2, 2 + n):
            K = torch.cat([K.narrow(ax, 1, 1), K.sum(ax, keepdim=True),
                           K.narrow(ax, 0, 1)], dim=ax)
        conv_t = F.conv_transpose2d if n == 2 else F.conv_transpose3d
        return conv_t(x, K.transpose(0, 1).to(x.dtype),
                      self.bias.to(x.dtype), stride=2, padding=1,
                      output_padding=1)


class SubpixelUpConv(_UpConv):
    """upsample2x -> conv 2^n SAME as 2^n convs on the source grid, one
    per output parity, interleaved
    (`multiplanarunet_tpu/models/unet.py:SubpixelUpConv`). Along an axis,
    an even output voxel's two taps read the same source voxel (the
    kernel axis is summed, extent 1), an odd one's read two neighbours
    (extent 2, the high edge zero-padded as SAME pads)."""

    def forward(self, x):
        n = self.ndim
        conv = F.conv2d if n == 2 else F.conv3d
        parts = []
        for parity in np.ndindex(*(2,) * n):
            k = self.weight
            for ax, p in enumerate(parity):
                if p == 0:
                    k = k.sum(dim=2 + ax, keepdim=True)
            pad = []
            for p in reversed(parity):  # F.pad lists the last axis first
                pad += [0, p]
            parts.append(conv(F.pad(x, pad), k.to(x.dtype)))
        # out[..., 2i + p, ...] = parts[parity][..., i, ...]
        B, F_, *sp = parts[0].shape
        y = torch.stack(parts, dim=2).view(B, F_, *(2,) * n, *sp)
        perm = [0, 1]
        for ax in range(n):  # (B, F, p0, .., s0, ..) -> (B, F, s0, p0, ..)
            perm += [2 + n + ax, 2 + ax]
        y = y.permute(perm).reshape(B, F_, *(2 * s for s in sp))
        return y + self.bias.to(x.dtype).view((1, -1) + (1,) * n)


def flattened(out):
    """(B, C, *spatial) -> (B, prod(spatial), C), the JAX models'
    `flatten_output` reshape of their channels-last output."""
    return out.movedim(1, -1).reshape(out.shape[0], -1, out.shape[1])


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
    softmax); with flatten_output, (B, prod(spatial'), n_classes) as the
    JAX model returns them."""

    ndim = 2

    def __init__(self, n_classes, n_channels=1, depth=4, complexity_factor=1.0,
                 init_filters=64, kernel_size=3, activation="relu",
                 out_activation="softmax", dtype=torch.float32,
                 subpixel_decoder=False, dilated_upconv=False,
                 predict_fused_bn=False, predict_skip_bn=False, lane_pad=0,
                 flatten_output=False):
        super().__init__()
        self.n_classes = int(n_classes)
        self.n_channels = int(n_channels)
        self.depth = int(depth)
        self.complexity_factor = float(complexity_factor)
        self.init_filters = int(init_filters)
        self.activation = activation
        self.out_activation = out_activation
        self.dtype = dtype
        self.subpixel_decoder = bool(subpixel_decoder)
        self.dilated_upconv = bool(dilated_upconv)
        self.predict_fused_bn = bool(predict_fused_bn)
        self.predict_skip_bn = bool(predict_skip_bn)
        self.lane_pad = int(lane_pad)
        self.flatten_output = bool(flatten_output)
        self.act = get_activation(activation)
        self.out_act = get_activation(out_activation)
        k = self.kernel_size = int(kernel_size)

        n = self.ndim
        bn = dict(fused_bn=self.predict_fused_bn,
                  skip_bn=self.predict_skip_bn)
        cin, filters = self.n_channels, self.init_filters
        for i in range(self.depth):
            f = self._filters(filters)
            self.add_module(f"encoder_L{i}",
                            ConvBNBlock(cin, f, k, self.act, n, **bn))
            cin, filters = f, filters * 2
        f = self._filters(filters)
        self.bottom = ConvBNBlock(cin, f, k, self.act, n, **bn)
        cin = f
        for i in range(self.depth):
            filters //= 2
            f = self._filters(filters)
            if self.subpixel_decoder:
                up = SubpixelUpConv(cin, f, n)
            elif self.dilated_upconv:
                up = DilatedUpConv(cin, f, n)
            else:
                # 2^n SAME conv after the upsample: SAME pads an even
                # kernel (0, 1), the high edge of every axis only (done
                # in forward)
                up = CONV[n](cin, f, 2)
            self.add_module(f"decoder_L{i}_conv_up", up)
            self.add_module(f"decoder_L{i}_bn_up",
                            _batch_norm(f, n, self.predict_fused_bn))
            self.add_module(f"decoder_L{i}",
                            ConvBNBlock(2 * f, f, k, self.act, n, **bn))
            cin = f
        self.out_conv = (nn.Conv2d if n == 2 else nn.Conv3d)(
            cin, self.n_classes, 1)
        self.label_crop = np.zeros((n, 2), np.int64)

    @property
    def cf(self):
        """sqrt(complexity_factor), the filter multiplier."""
        return float(np.sqrt(self.complexity_factor))

    def _filters(self, base):
        """int(base * cf), rounded up to a multiple of lane_pad when set
        (the out conv keeps n_classes)."""
        f = int(base * self.cf)
        if self.lane_pad:
            f = -(-f // self.lane_pad) * self.lane_pad
        return f

    def copy(self, **overrides):
        """A new model of this class with the same fields but
        `overrides` (flax's `Module.copy`): fresh parameters, built where
        torch builds modules (the CPU, or a `torch.device` context)."""
        fields = inspect.signature(type(self)).parameters
        return type(self)(**{**{k: getattr(self, k) for k in fields},
                             **overrides})

    def twin(self, **fields):
        """This model with `fields` changed and its weights carried: a new
        model on the same device, in the same mode, loaded from this one's
        state dict (zero-embedded by `lane_pad_variables` when `fields`
        sets lane_pad). This model is left as it is."""
        state = self.state_dict()
        if fields.get("lane_pad", self.lane_pad) != self.lane_pad:
            state = lane_pad_variables(self, state, fields["lane_pad"])
        with torch.device(next(self.parameters()).device):
            twin = self.copy(**fields)
        twin.load_state_dict(state)
        return twin.train(self.training)

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
        skip_bn = self.predict_skip_bn and not self.training
        for i in range(self.depth):
            up = getattr(self, f"decoder_L{i}_conv_up")
            if not isinstance(up, _UpConv):  # the naive form
                x = F.pad(upsample2x(x), (0, 1) * n)
            x = self.act(up(x))
            if not skip_bn:
                x = getattr(self, f"decoder_L{i}_bn_up")(x)
            skip, crops = crop_to_match(skips[-(i + 1)], x)
            label_crop += crops
            x = getattr(self, f"decoder_L{i}")(torch.cat([skip, x], dim=1))
        self.label_crop = label_crop
        # The out conv runs in float32 whatever the compute dtype
        out = self.out_act(self.out_conv(x.float()))
        return flattened(out) if self.flatten_output else out

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


def scope_key(key, path, counter):
    """The key flax's `make_rng('params')` gives the `counter`-th draw of
    the module scope at `path` under root key `key`
    (`flax/core/scope.py:_fold_in_static` without the rng separator,
    flax's default): fold_in of the first 4 bytes, big-endian, of the
    SHA-1 of the path's names and the counter."""
    h = hashlib.sha1()
    for x in (*path, counter):
        if isinstance(x, str):
            h.update(x.encode("utf-8"))
        else:
            h.update(int(x).to_bytes((int(x).bit_length() + 7) // 8, "big"))
    return prng.fold_in(key, int.from_bytes(h.digest()[:4], "big"))


def glorot_scale(shape):
    """The float32 factor sqrt(3 * variance) of glorot-uniform for a flax
    conv kernel shape (*spatial, I, O): variance = 1 / fan_avg rounded to
    float32, then 3 * variance and its root in float32, as
    `jax.nn.initializers.variance_scaling` computes it."""
    field = float(np.prod(shape[:-2]))
    fan_in, fan_out = shape[-2] * field, shape[-1] * field
    variance = np.float32(1.0 / ((fan_in + fan_out) / 2))
    return np.sqrt(np.float32(3) * variance)


def glorot_uniform(key, shape, device):
    """`jax.nn.initializers.glorot_uniform()(key, shape, float32)`:
    uniform in [-1, 1) times `glorot_scale(shape)`, in float32."""
    return prng.uniform(key, shape, -1.0, 1.0, device=device,
                        scale=glorot_scale(shape))


def init_unet(model, key, device=None):
    """The flax (params, batch_stats) trees that the JAX package's
    `init_unet` (and `init_model_variables`) gives the same UNet, UNet3D
    or MultiTaskUNet2D from `key` (a `prng.PRNGKey`), as tensors on
    `device` (the card unless the caller names the CPU): each conv kernel
    glorot-uniform in flax's shape from its scope's first make_rng key
    (a kernel is each conv scope's first parameter), every bias 0, every
    BatchNorm at scale 1, mean 0, var 1. The module paths are the flax
    scope paths (`checkpoint.flax_variables`), so every form and the lane
    padding draw what the JAX model of that build draws."""
    device = resolve_device(device)
    trees = {"params": {}, "batch_stats": {}}
    for coll, path, shape in checkpoint.flax_variables(model):
        if path[-1] == "kernel":
            value = glorot_uniform(scope_key(key, path[:-1], 1), shape,
                                   device)
        else:
            fill = 1.0 if path[-1] in ("scale", "var") else 0.0
            value = torch.full(shape, fill, dtype=torch.float32,
                               device=device)
        node = trees[coll]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value
    return trees["params"], trees["batch_stats"]


def glorot_init(model, seed=0, device=None):
    """Initialise `model` in place with the weights the JAX package's
    flax init gives the same model from PRNGKey(seed) (`init_unet`),
    drawn on `device` (the card unless the caller names the CPU) and
    loaded through the checkpoint converter. Returns the model."""
    params, stats = init_unet(model, prng.PRNGKey(seed), device)
    model.load_state_dict(
        checkpoint.unet_state_dict_from_jax(params, stats, model))
    return model


def lane_pad_variables(model, state_dict, lane_pad):
    """`model`'s state dict (`state_dict`) zero-embedded into the shapes
    of `model.copy(lane_pad=lane_pad)`, as
    `multiplanarunet_tpu/models/unet.py:lane_pad_variables` embeds a flax
    tree; the padded model computes the same outputs. Padded kernel rows
    and columns are zero (a padded output channel stays zero through bias
    0), padded BatchNorm channels are the identity on it (weight 1, bias
    0, mean 0, var 1), and the out conv's padded input rows are zero.
    Level i's decoder concat is [skip (f padded to P(f)), up (likewise)],
    so `decoder_L{i}.conv1`'s real input rows, torch's dim 1, are
    [0, f) and [P(f), P(f) + f). Entries whose shape does not change are
    returned as they are."""
    if model.lane_pad:
        raise ValueError(f"lane_pad_variables embeds an unpadded model's "
                         f"weights; this one has lane_pad {model.lane_pad}")
    with torch.device("meta"):
        padded = model.copy(lane_pad=lane_pad)
    P = lambda c: -(-c // lane_pad) * lane_pad  # noqa: E731
    dec_f = {f"decoder_L{i}":
             int(model.init_filters * 2 ** (model.depth - 1 - i) * model.cf)
             for i in range(model.depth)}
    out = {}
    for key, ref in padded.state_dict().items():
        src = state_dict[key]
        if src.shape == ref.shape:
            out[key] = src
            continue
        *mods, leaf = key.split(".")
        fill = 1.0 if leaf == "running_var" or (
            leaf == "weight" and src.dim() == 1) else 0.0
        tgt = torch.full(ref.shape, fill, dtype=src.dtype, device=src.device)
        o = src.shape[0]
        if src.dim() > 1:  # conv kernel (O, I, *k)
            if len(mods) >= 2 and mods[-2] in dec_f and mods[-1] == "conv1":
                f = dec_f[mods[-2]]
                if src.shape[1] != 2 * f:
                    raise ValueError(f"{key}: {src.shape[1]} input "
                                     f"channels, not the concat's {2 * f}")
                tgt[:o, :f] = src[:, :f]
                tgt[:o, P(f):P(f) + f] = src[:, f:]
            else:
                tgt[:o, :src.shape[1]] = src
        else:  # per-channel: bias, BatchNorm weight / bias / statistics
            tgt[:o] = src
        out[key] = tgt
    return out
