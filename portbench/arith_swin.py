"""The yardstick's arithmetic of the Swin UNETR configuration, frozen here
as `arith.py` freezes the U-Net's: the forward FLOPs of one box and the
least work of its windowed attention, counted from the configuration
alone, whatever form the program computes them in."""

from __future__ import annotations

import math

from portbench import arith

BF16_BYTES = 2


def stages(build):
    """Per stage: (grid side g, dim C, heads, window side w, padded side P,
    blocks), for a box of side build["dim"] (patch 2, four stages)."""
    F_ = int(build["feature_size"])
    window = int(build["window_size"])
    g = int(build["dim"]) // int(build["patch_size"])
    out = []
    for i, (depth, heads) in enumerate(zip(build["depths"],
                                           build["num_heads"])):
        w = min(g, window)
        out.append((g, F_ * 2 ** i, int(heads), w, math.ceil(g / w) * w,
                    int(depth)))
        g //= 2
    return out


def _res_macs(s, cin, cout):
    """A residual block at s^3: two 3^3 convs, the 1^3 conv where the
    channels change."""
    return s ** 3 * (27 * (cin * cout + cout * cout)
                     + (cin * cout if cin != cout else 0))


def _up_macs(s, cin, cout):
    """An up-block to s^3: the transposed 2^3 conv (cin x cout a voxel of
    its output), then a residual block of 2 cout -> cout."""
    return s ** 3 * cin * cout + _res_macs(s, 2 * cout, cout)


def forward_flops(build):
    """Forward FLOPs (2 x multiply-adds) of one dim^3 box: the patch
    embedding, per block the qkv and output projections over the padded
    grid, q k^T and p v over its windows, the MLP over the grid, the
    patch mergings, every decoder conv and the out conv. Norms,
    activations, softmax and the bias add are left out."""
    D = int(build["dim"])
    F_ = int(build["feature_size"])
    p = int(build["patch_size"])
    macs = (D // p) ** 3 * F_ * int(build["n_channels"]) * p ** 3
    for g, C, _, w, P, depth in stages(build):
        attn = P ** 3 * (4 * C * C + 2 * w ** 3 * C)
        macs += depth * (attn + g ** 3 * 8 * C * C)
        macs += (g // 2) ** 3 * 8 * C * 2 * C
    macs += _res_macs(D, int(build["n_channels"]), F_)
    macs += _res_macs(D // 2, F_, F_)
    macs += _res_macs(D // 4, 2 * F_, 2 * F_)
    macs += _res_macs(D // 8, 4 * F_, 4 * F_)
    macs += _res_macs(D // 32, 16 * F_, 16 * F_)
    for k in range(4, -1, -1):  # decoder5 .. decoder1
        cout = F_ * 2 ** max(k - 1, 0)
        macs += _up_macs(D // 2 ** k, F_ * 2 ** k, cout)
    macs += D ** 3 * F_ * int(build["n_classes"])
    return 2.0 * macs


def attention_work(build, batch):
    """(bytes, FLOPs, windows x heads) of the windowed attention of one
    forward of `batch` boxes, whatever implements it: per block and
    window-head q k^T and p v (4 N^2 head_dim FLOPs), q, k, v and the
    output read or written once in bf16, and the bias once per block in
    bf16 (one N x N per head shared by every window, or in a shifted
    block one per window position and head)."""
    n_bytes = flops = window_heads = 0.0
    for _, C, heads, w, P, depth in stages(build):
        N = w ** 3
        n_win = (P // w) ** 3
        hd = C // heads
        shifted = depth // 2 if P > w else 0
        wh = batch * n_win * heads
        window_heads += depth * wh
        flops += depth * wh * 4.0 * N * N * hd
        n_bytes += depth * wh * 4.0 * N * hd * BF16_BYTES
        n_bytes += ((depth - shifted) * heads
                    + shifted * n_win * heads) * N * N * BF16_BYTES
    return n_bytes, flops, window_heads


def attention_least_seconds(build, batch, window_heads):
    """The least time of the attention that attended `window_heads`
    windows x heads in forwards of `batch` boxes: that many forwards'
    `attention_work` at the HBM bandwidth or the bf16 dense peak, the
    larger."""
    n_bytes, flops, per_forward = attention_work(build, batch)
    return (window_heads / per_forward) * arith.least_seconds(
        n_bytes, flops, arith.PEAKS["bf16_flops"])
