"""2D U-Net for inference, in torch.

Port of `multiplanarunet_tpu/models/unet.py:UNet` at the same topology:
a depth-N encoder of [conv3x3 SAME -> ReLU] x2 -> BatchNorm -> maxpool
2x2, a bottom block, and a decoder of [nearest 2x upsample -> conv2x2 SAME
-> ReLU -> BatchNorm -> crop skip to match -> concat [skip, up] -> ConvBN
block], then a float32 1x1 out conv and softmax. Filters are
int(init_filters * 2^i * sqrt(complexity_factor)).

Layout is NCHW. Parameters and BatchNorm statistics stay float32; the
convolutions run in `dtype` (bf16 on the card), as the JAX model's
`dtype` does, and BatchNorm normalises in float32 (eval mode, eps 1e-3,
running statistics). Weights come from the JAX package's checkpoints
through `models.checkpoint.unet_state_dict_from_jax`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    """Conv with float32 parameters that computes in the input's dtype."""

    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype),
                                  self.bias.to(x.dtype))


class BatchNorm2d(nn.BatchNorm2d):
    """Inference BatchNorm (Keras eps 1e-3) normalising in float32 from the
    running statistics and returning the input's dtype."""

    def __init__(self, channels):
        super().__init__(channels, eps=1e-3, momentum=0.01)

    def forward(self, x):
        y = F.batch_norm(x.float(), self.running_mean, self.running_var,
                         self.weight, self.bias, False, 0.0, self.eps)
        return y.to(x.dtype)


class ConvBNBlock(nn.Module):
    """Two 3x3 SAME convs with ReLU, then BatchNorm."""

    def __init__(self, in_channels, filters):
        super().__init__()
        self.conv1 = Conv2d(in_channels, filters, 3, padding="same")
        self.conv2 = Conv2d(filters, filters, 3, padding="same")
        self.bn = BatchNorm2d(filters)

    def forward(self, x):
        x = F.relu(self.conv1(x))
        x = F.relu(self.conv2(x))
        return self.bn(x)


def crop_to_match(skip, up):
    """Center-crop `skip`'s spatial dims (NCHW) down to `up`'s."""
    diff = np.array(skip.shape[2:]) - np.array(up.shape[2:])
    if np.all(diff == 0):
        return skip
    lo = diff // 2
    hi = diff - lo
    return skip[:, :, lo[0]:skip.shape[2] - hi[0], lo[1]:skip.shape[3] - hi[1]]


class UNet(nn.Module):
    """Configurable-depth 2D U-Net with complexity scaling (inference), at
    the JAX model's defaults: 3x3 kernels, ReLU, softmax out.

    forward: (B, n_channels, H, W) -> (B, n_classes, H', W') float32
    probabilities."""

    def __init__(self, n_classes, n_channels=1, depth=4, complexity_factor=1.0,
                 init_filters=64, dtype=torch.float32):
        super().__init__()
        self.n_classes = int(n_classes)
        self.n_channels = int(n_channels)
        self.depth = int(depth)
        self.dtype = dtype
        cf = float(np.sqrt(complexity_factor))

        cin, filters = self.n_channels, init_filters
        for i in range(self.depth):
            f = int(filters * cf)
            self.add_module(f"encoder_L{i}", ConvBNBlock(cin, f))
            cin, filters = f, filters * 2
        f = int(filters * cf)
        self.bottom = ConvBNBlock(cin, f)
        cin = f
        for i in range(self.depth):
            filters //= 2
            f = int(filters * cf)
            # 2x2 SAME conv after the upsample: SAME pads an even kernel
            # (0, 1), the high edge only (done in forward)
            self.add_module(f"decoder_L{i}_conv_up", Conv2d(cin, f, 2))
            self.add_module(f"decoder_L{i}_bn_up", BatchNorm2d(f))
            self.add_module(f"decoder_L{i}", ConvBNBlock(2 * f, f))
            cin = f
        self.out_conv = nn.Conv2d(cin, self.n_classes, 1)

    def forward(self, x):
        x = x.to(self.dtype)
        skips = []
        for i in range(self.depth):
            x = getattr(self, f"encoder_L{i}")(x)
            skips.append(x)
            x = F.max_pool2d(x, 2, 2)
        x = self.bottom(x)
        for i in range(self.depth):
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = getattr(self, f"decoder_L{i}_conv_up")(F.pad(x, (0, 1, 0, 1)))
            x = getattr(self, f"decoder_L{i}_bn_up")(F.relu(x))
            skip = crop_to_match(skips[-(i + 1)], x)
            x = getattr(self, f"decoder_L{i}")(torch.cat([skip, x], dim=1))
        # The out conv runs in float32 whatever the compute dtype
        return torch.softmax(self.out_conv(x.float()), dim=1)
