"""Multi-task 2D U-Net, in torch: one shared encoder, a decoder and
classifier per task.

Port of `multiplanarunet_tpu/models/multitask_unet.py:MultiTaskUNet2D` on
the 2D U-Net's blocks (`models/unet.py`): the encoder (`encoder_L{i}`
ConvBN blocks, each followed by a 2x2 maxpool) runs on every task's input
with the same parameters; each task owns a bottom block, a decoder of
[nearest 2x upsample -> 2x2 SAME conv -> act -> BatchNorm -> crop skip ->
concat [skip, up] -> block] and a float32 1x1 out conv with the output
activation. The JAX decoder's `SubpixelUpConv` is that upsample and conv
computed per output parity, exact up to reassociation and with the same
parameters, so the port computes it as the U-Net does. Tasks may differ in
sample dim and class count; they share `n_channels`, which the encoder's
first conv fixes.

Modules are named as flax names them (`encoder.encoder_L{i}`,
`task_{name}.bottom`, `task_{name}.decoder_L{i}_conv_up`, ...), so
`models/checkpoint.py` carries weights between the packages unchanged. In
train mode the encoder's BatchNorms update their running statistics once
per task, in task order, as flax's in-place `batch_stats` update does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multiplanarunet_tpu_torch.models.unet import (
    BATCH_NORM,
    CONV,
    ConvBNBlock,
    count_params,
    crop_to_match,
    get_activation,
    output_activation,
)


class _SharedEncoder(nn.Module):
    def __init__(self, n_channels, depth, cf, init_filters, kernel_size, act):
        super().__init__()
        self.depth = depth
        cin, filters = n_channels, init_filters
        for i in range(depth):
            f = int(filters * cf)
            self.add_module(f"encoder_L{i}",
                            ConvBNBlock(cin, f, kernel_size, act))
            cin, filters = f, filters * 2
        self.out_channels, self.filters = cin, filters

    def forward(self, x):
        skips = []
        for i in range(self.depth):
            x = getattr(self, f"encoder_L{i}")(x)
            skips.append(x)
            x = F.max_pool2d(x, 2, 2)
        return x, skips


class _TaskDecoder(nn.Module):
    def __init__(self, n_classes, in_channels, filters, depth, cf,
                 kernel_size, act, out_act):
        super().__init__()
        self.depth, self.act, self.out_act = depth, act, out_act
        f = int(filters * cf)
        self.bottom = ConvBNBlock(in_channels, f, kernel_size, act)
        cin = f
        for i in range(depth):
            filters //= 2
            f = int(filters * cf)
            self.add_module(f"decoder_L{i}_conv_up", CONV[2](cin, f, 2))
            self.add_module(f"decoder_L{i}_bn_up", BATCH_NORM[2](f))
            self.add_module(f"decoder_L{i}",
                            ConvBNBlock(2 * f, f, kernel_size, act))
            cin = f
        self.out_conv = nn.Conv2d(cin, n_classes, 1)

    def forward(self, x, skips):
        x = self.bottom(x)
        for i in range(self.depth):
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            # 2x2 SAME conv: padded (0, 1), the high edge only
            x = getattr(self, f"decoder_L{i}_conv_up")(F.pad(x, (0, 1) * 2))
            x = getattr(self, f"decoder_L{i}_bn_up")(self.act(x))
            skip, _ = crop_to_match(skips[-(i + 1)], x)
            x = getattr(self, f"decoder_L{i}")(torch.cat([skip, x], dim=1))
        # The out conv runs in float32 whatever the compute dtype
        return self.out_act(self.out_conv(x.float()))


class MultiTaskUNet2D(nn.Module):
    """forward: a list of (B_t, n_channels, H_t, W_t) per task -> a list
    of (B_t, n_classes[t], H_t, W_t) float32 outputs of out_activation."""

    def __init__(self, task_names, n_classes, n_channels, dim=None, depth=4,
                 complexity_factor=1.0, init_filters=64, kernel_size=3,
                 activation="relu", out_activation="softmax",
                 dtype=torch.float32):
        super().__init__()
        self.task_names = [str(t) for t in task_names]
        self.n_classes = [int(n) for n in n_classes]
        self.n_channels = [int(c) for c in n_channels]
        self.dim = None if dim is None else [int(d) for d in dim]
        if len(self.n_classes) != self.n_tasks or \
                len(self.n_channels) != self.n_tasks:
            raise ValueError(
                f"task_names, n_classes and n_channels differ in length: "
                f"{self.task_names}, {self.n_classes}, {self.n_channels}")
        if len(set(self.n_channels)) != 1:
            # The shared first conv fixes the input channel count
            raise ValueError(
                "All tasks must share the same n_channels to share an "
                f"encoder; got {tuple(self.n_channels)}")
        self.depth = int(depth)
        self.dtype = dtype
        act = get_activation(activation)
        out_act = output_activation(out_activation)
        cf = float(np.sqrt(complexity_factor))
        k = int(kernel_size)
        self.encoder = _SharedEncoder(self.n_channels[0], self.depth, cf,
                                      init_filters, k, act)
        for name, nc in zip(self.task_names, self.n_classes):
            # Registered by name, not in a ModuleDict: the flax tree has
            # the task heads at its top level
            self.add_module(f"task_{name}", _TaskDecoder(
                nc, self.encoder.out_channels, self.encoder.filters,
                self.depth, cf, k, act, out_act))

    @property
    def n_tasks(self):
        return len(self.task_names)

    def count_params(self):
        return count_params(self)

    def forward(self, inputs):
        if len(inputs) != self.n_tasks:
            raise ValueError(f"Expected {self.n_tasks} task inputs, got "
                             f"{len(inputs)}")
        outputs = []
        for name, x in zip(self.task_names, inputs):
            feats, skips = self.encoder(x.to(self.dtype))
            outputs.append(getattr(self, f"task_{name}")(feats, skips))
        return outputs
