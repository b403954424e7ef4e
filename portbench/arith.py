"""The yardstick's arithmetic: operations, bytes and the card's peaks.

Frozen here so that a change to the program cannot change what the
benchmark counts. `unet_forward_flops` is a copy of
`multiplanarunet_tpu_torch/utils/conv_arithmetics.py:unet_forward_flops`
written for any spatial rank: 2 x the multiply-adds of every convolution
of the plain U-Net (nearest upsample + 2^n conv decoder, unpadded
filters), whatever form the program runs. BatchNorm, activations,
pooling and upsampling are left out (under 1% of the work).
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
PEAKS = {
    "bf16_flops": 989e12,
    "fp32_flops": 67e12,
    "hbm_bytes_per_s": 3.35e12,
}


def unet_forward_flops(dim, n_classes, n_channels=1, depth=4,
                       init_filters=64, complexity_factor=1.0,
                       kernel_size=3, ndim=2):
    """Forward FLOPs of one dim^ndim input through the plain U-Net: per
    encoder level two k^n SAME convs, the bottom likewise, per decoder
    level one 2^n up conv after the nearest upsample and two k^n convs on
    the skip concat, then the 1^n out conv."""
    cf = complexity_factor ** 0.5
    ch = [int(init_filters * (2 ** i) * cf) for i in range(depth + 1)]
    kn = kernel_size ** ndim
    up_taps = 2 ** ndim
    fl = 0.0
    d = dim
    cin = n_channels
    for c in ch[:depth]:
        fl += 2.0 * d ** ndim * kn * (cin * c + c * c)
        cin = c
        d //= 2
    fl += 2.0 * d ** ndim * kn * (ch[depth - 1] * ch[depth]
                                  + ch[depth] * ch[depth])
    for i in range(depth):
        cup, cskip = ch[depth - i], ch[depth - 1 - i]
        d *= 2
        fl += 2.0 * d ** ndim * (up_taps * cup * cskip
                                 + kn * (2 * cskip * cskip + cskip * cskip))
    fl += 2.0 * dim ** ndim * ch[0] * n_classes
    return fl


def config_forward_flops(build):
    """Forward FLOPs of one sample (a dim^2 plane or a dim^3 box) of a
    configuration's build group."""
    ndim = 3 if build["model_class_name"] == "UNet3D" else 2
    return unet_forward_flops(
        int(build["dim"]), int(build["n_classes"]),
        int(build["n_channels"]), int(build["depth"]),
        int(build.get("init_filters", 64)),
        float(build["complexity_factor"]), int(build.get("kernel_size", 3)),
        ndim)


def resample_work(vol_shape, n_channels, dim, n_planes, n_views, n_classes):
    """(bytes, FLOPs) that the predict path's resample layer must at least
    move and compute for one volume, whatever implements it:

    * the stack: the staged volume (bf16) read once, each view's
      dim x dim x n_planes plane stack (bf16) written once, and a
      trilinear interpolation per sample and channel (8 taps: 16 FLOPs);
    * the remap: each view's bf16 prediction stack read once, the float32
      fusion accumulator read and written once, and per voxel, view and
      class a trilinear interpolation plus the weighted accumulate (18
      FLOPs)."""
    n_vox = float(vol_shape[0]) * vol_shape[1] * vol_shape[2]
    stack_samples = float(dim) * dim * n_planes * n_views
    stack_bytes = n_vox * n_channels * 2 + stack_samples * n_channels * 2
    stack_flops = stack_samples * n_channels * 16
    remap_bytes = (stack_samples * n_classes * 2
                   + n_vox * n_classes * 4 * 2)
    remap_flops = n_vox * n_views * n_classes * 18
    return stack_bytes + remap_bytes, stack_flops + remap_flops


def least_seconds(n_bytes, flops, flops_peak=PEAKS["fp32_flops"]):
    """The least time the card could take: the larger of bytes over HBM
    bandwidth and operations over the peak rate."""
    return max(n_bytes / PEAKS["hbm_bytes_per_s"], flops / flops_peak)
