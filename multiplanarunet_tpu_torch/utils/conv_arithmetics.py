"""Receptive-field arithmetic for the U-Net encoder.

Port of `multiplanarunet_tpu/utils/conv_arithmetics.py`. The reference
computes receptive fields by walking Keras layer objects
(`mpunet/utils/conv_arithmetics.py`); here the network topology is known
statically, so the closed-form recurrence suffices:

    r_{l+1} = r_l + (k_l - 1) * j_l,   j_{l+1} = j_l * s_l
"""

from __future__ import annotations


def receptive_field(layers):
    """Receptive field after a sequence of (kernel_size, stride) layers."""
    r, j = 1, 1
    for k, s in layers:
        r += (k - 1) * j
        j *= s
    return r, j


def unet_encoder_receptive_field(depth, kernel_size=3, pool=2):
    """Receptive field at the deepest encoder feature of a standard U-Net
    encoder: per level [conv k, conv k, pool 2] repeated `depth` times."""
    layers = []
    for _ in range(depth):
        layers += [(kernel_size, 1), (kernel_size, 1), (pool, pool)]
    return receptive_field(layers)[0]


def unet_forward_flops(dim, n_classes, n_channels=1, depth=4,
                       init_filters=64, complexity_factor=1.0,
                       kernel_size=3):
    """Analytic forward FLOPs (2x MACs, convs only) of one `dim`x`dim`
    plane through the 2D U-Net of `models/unet.py`. BN / activations /
    pooling / upsampling contribute <1% and are excluded, so dividing by
    wall time gives a (slightly conservative) model-FLOPs utilization.

    Mirrors the topology of the reference model
    (`mpunet/models/unet.py:114-180`): per encoder level
    two SAME kxk convs; bottom likewise; per decoder level one 2x2
    up-conv after nearest upsampling plus two kxk convs on the
    skip-concat; final 1x1 output conv."""
    cf = complexity_factor ** 0.5
    ch = [int(init_filters * (2 ** i) * cf) for i in range(depth + 1)]
    k2 = kernel_size * kernel_size
    fl = 0.0
    d = dim
    cin = n_channels
    for c in ch[:depth]:                       # encoder
        fl += 2.0 * d * d * k2 * (cin * c + c * c)
        cin = c
        d //= 2
    fl += 2.0 * d * d * k2 * (ch[depth - 1] * ch[depth]
                              + ch[depth] * ch[depth])   # bottom
    for i in range(depth):                     # decoder
        cup, cskip = ch[depth - i], ch[depth - 1 - i]
        d *= 2
        fl += 2.0 * d * d * (4 * cup * cskip              # 2x2 up-conv
                             + k2 * (2 * cskip * cskip    # conv on concat
                                     + cskip * cskip))
    fl += 2.0 * dim * dim * ch[0] * n_classes  # 1x1 out conv
    return fl
