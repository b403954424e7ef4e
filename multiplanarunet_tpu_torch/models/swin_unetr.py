"""Swin UNETR, in torch (NCDHW), for training and inference over 3D boxes.

The BTCV configuration of Tang et al. (CVPR 2022, arXiv:2111.14791) and
Hatamizadeh et al. (arXiv:2201.01266), in the v1 form of MONAI's
`monai.networks.nets.SwinUNETR`. The JAX package has no counterpart.

* Encoder (`swinViT`): a patch embedding (conv k = s = patch_size, with
  bias), then four stages at dim F * 2^i, each `depths[i]` Swin blocks
  and a patch merging. A block is x += attn(norm1(x)); x += mlp(norm2(x)).
  `attn` zero-pads the normed tokens up to a multiple of the window,
  cyclically shifts odd blocks by window // 2 (roll by -s, then back by
  +s) with a -100 mask between the 27 regions of the padded grid, and
  attends in windows of N = w^3 tokens: qkv Linear(C, 3C), scale
  head_dim^-0.5, q k^T + B_rel (+ mask), softmax, @ v, Linear(C, C).
  B_rel comes from a (2 window - 1)^3 x heads table indexed by the
  relative offsets of the window in use. Where a stage's grid is no
  larger than the window, the window is the grid and the shift 0. The
  MLP is Linear(C, 4C), exact GELU, Linear(4C, C). Patch merging
  concatenates each 2x2x2 neighbourhood in `itertools.product` order
  (as the paper describes and MONAI's PatchMergingV2 does; MONAI's
  legacy `merging` repeats two slices), LayerNorm(8C), Linear(8C, 2C, no
  bias). The embedding and each stage's output go to the decoder through
  a LayerNorm without affine; the next stage takes the un-normed tensor.
* Decoder (UNETR): residual blocks (conv 3^3 no bias -> InstanceNorm ->
  LeakyReLU 0.01 -> conv 3^3 -> InstanceNorm, plus the input through a
  conv 1^3 + InstanceNorm where the channels change, -> LeakyReLU) on the
  image and the encoder's outputs, up-blocks (transposed conv 2^3 stride
  2 without bias, concat [up, skip], residual block), and a conv 1^3
  with bias to the classes, then `out_activation` in float32.

Attention runs through `F.scaled_dot_product_attention` with B_rel and
the shift mask as one float bias per block, the mask built once a stage.
Parameters stay float32; under `dtype` bf16 the convolutions, linears
and attention compute in bf16 and LayerNorm and InstanceNorm normalise
in float32, as the port's U-Nets do; the out conv and the output
activation run in float32.

With the recorder on (`utils/trace.py`), the forward records the device
spans `swin.encoder`, `swin.attn` (each block's shift, partition, qkv,
attention, projection and reverse) and `swin.decoder`, and the counter
`swin.windows` (windows x heads attended).

Weights are saved and restored by torch parameter name
(`models/checkpoint.py`); `swin_init` draws the seeded initial weights
through `ops/prng.py`.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from multiplanarunet_tpu_torch.models.unet import get_activation
from multiplanarunet_tpu_torch.utils import trace

NORM_EPS = 1e-5
MASK_VALUE = -100.0
LEAKY_SLOPE = 0.01
# A box side must divide by the patch and the four mergings: 2 x 2^4
BOX_MULTIPLE = 32


def window_in_use(grid, window, shift):
    """(window, shift) per axis as a block uses them: on an axis whose
    grid is no larger than the window, the grid and no shift."""
    ws = tuple(g if g <= window else window for g in grid)
    ss = tuple(0 if g <= window else shift for g in grid)
    return ws, ss


def relative_index(ws, table_window):
    """(N, N) int64 rows of the (2 table_window - 1)^3 table for the
    relative 3D offsets within a window of sides ws (N = prod(ws))."""
    coords = torch.stack(torch.meshgrid(
        *[torch.arange(w) for w in ws], indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel = rel + (table_window - 1)
    side = 2 * table_window - 1
    return (rel[..., 0] * side + rel[..., 1]) * side + rel[..., 2]


def partition(x, ws):
    """(B, D, H, W, C) -> windows (B * nW, N, C), windows in (B, d, h, w)
    order."""
    B, D, H, W, C = x.shape
    x = x.view(B, D // ws[0], ws[0], H // ws[1], ws[1], W // ws[2], ws[2],
               C)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, math.prod(ws), C)


def unpartition(windows, ws, B, D, H, W):
    """The inverse of `partition`."""
    C = windows.shape[-1]
    x = windows.view(B, D // ws[0], H // ws[1], W // ws[2], ws[0], ws[1],
                     ws[2], C)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(B, D, H, W, C)


def shift_mask(padded, ws, ss, device=None):
    """(nW, N, N) float32: 0 between tokens of the same region of the
    padded grid, MASK_VALUE between regions (the regions are the cuts at
    -window and -shift along each axis)."""
    region = torch.zeros((1,) + tuple(padded) + (1,), device=device)
    cuts = [(slice(0, -w), slice(-w, -s), slice(-s, None))
            for w, s in zip(ws, ss)]
    for n, (a, b, c) in enumerate(itertools.product(*cuts)):
        region[:, a, b, c] = n
    win = partition(region, ws)[..., 0]
    diff = win[:, None, :] - win[:, :, None]
    return torch.where(diff != 0, MASK_VALUE, 0.0)


def _aligned(bias):
    """`bias` (..., N, N) as a view into storage whose rows are padded to a
    multiple of 16 elements: the fused attention kernels take such a
    bias as it is, where they would copy an unaligned one."""
    n = bias.shape[-1]
    return F.pad(bias, (0, -n % 16))[..., :n]


def _linear(x, m):
    """`m` (an nn.Linear) over x in x's dtype, float32 parameters cast."""
    return F.linear(x, m.weight.to(x.dtype),
                    None if m.bias is None else m.bias.to(x.dtype))


def _conv(x, m):
    """`m` (a Conv3d or ConvTranspose3d) over x in x's dtype."""
    w = m.weight.to(x.dtype)
    b = None if m.bias is None else m.bias.to(x.dtype)
    if isinstance(m, nn.ConvTranspose3d):
        return F.conv_transpose3d(x, w, b, m.stride)
    return F.conv3d(x, w, b, m.stride, m.padding)


def _layer_norm(x, m=None):
    """LayerNorm over the last axis in float32 (with `m`'s affine, or none),
    returned in x's dtype."""
    if m is None:
        return F.layer_norm(x.float(), (x.shape[-1],),
                            eps=NORM_EPS).to(x.dtype)
    return F.layer_norm(x.float(), m.normalized_shape, m.weight, m.bias,
                        m.eps).to(x.dtype)


def _instance_norm(x):
    """InstanceNorm without affine (eps 1e-5) in float32, returned in x's
    dtype. A single voxel normalises to 0 (F.instance_norm refuses it)."""
    if math.prod(x.shape[2:]) == 1:
        return x - x
    return F.instance_norm(x.float(), eps=NORM_EPS).to(x.dtype)


class WindowAttention(nn.Module):
    def __init__(self, dim, heads, window):
        super().__init__()
        self.heads = heads
        self.window = window
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 3, heads))
        self._index = {}

    def rel_bias(self, ws, dtype):
        """B_rel (heads, N, N) of a window of sides ws, in dtype."""
        idx = self._index.get(ws)
        table = self.relative_position_bias_table
        if idx is None or idx.device != table.device:
            idx = relative_index(ws, self.window).to(table.device)
            self._index[ws] = idx
        n = idx.shape[0]
        return table[idx.reshape(-1)].view(n, n, -1).permute(2, 0, 1).to(
            dtype)

    def forward(self, windows, bias, n_windows):
        """windows (B * nW, N, C); bias (heads, N, N) shared by every
        window, or (nW, heads, N, N) one per window position."""
        Bn, N, C = windows.shape
        h = self.heads
        qkv = _linear(windows, self.qkv).view(Bn, N, 3, h, C // h)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        if bias.dim() == 3:
            out = F.scaled_dot_product_attention(q, k, v,
                                                 attn_mask=bias[None])
        else:
            # One batch row per sample, windows folded into the heads, so
            # that the per-window bias broadcasts over the samples alone
            fold = (Bn // n_windows, n_windows * h, N, C // h)
            out = F.scaled_dot_product_attention(
                q.reshape(fold), k.reshape(fold), v.reshape(fold),
                attn_mask=bias.reshape((1,) + fold[1:3] + (N,)))
            out = out.reshape(Bn, h, N, C // h)
        trace.count("swin.windows", Bn * h)
        return _linear(out.transpose(1, 2).reshape(Bn, N, C), self.proj)


class Mlp(nn.Module):
    def __init__(self, dim, ratio=4):
        super().__init__()
        self.linear1 = nn.Linear(dim, ratio * dim)
        self.linear2 = nn.Linear(ratio * dim, dim)

    def forward(self, x):
        return _linear(F.gelu(_linear(x, self.linear1)), self.linear2)


class SwinBlock(nn.Module):
    def __init__(self, dim, heads, window, shifted):
        super().__init__()
        self.shifted = shifted
        self.norm1 = nn.LayerNorm(dim, eps=NORM_EPS)
        self.attn = WindowAttention(dim, heads, window)
        self.norm2 = nn.LayerNorm(dim, eps=NORM_EPS)
        self.mlp = Mlp(dim)

    def attend(self, x, plan):
        """The attention branch of x (B, D, H, W, C): norm, pad, shift,
        partition, window attention, reverse."""
        ws, ss, padded, mask = plan
        B, D, H, W, C = x.shape
        y = _layer_norm(x, self.norm1)
        pads = [p - g for p, g in zip(padded, (D, H, W))]
        y = F.pad(y, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        shift = self.shifted and any(ss)
        if shift:
            y = torch.roll(y, [-s for s in ss], dims=(1, 2, 3))
        bias = self.attn.rel_bias(ws, y.dtype)
        n_windows = math.prod(p // w for p, w in zip(padded, ws))
        if shift:
            bias = bias[None] + mask[:, None].to(y.dtype)
        y = self.attn(partition(y, ws), _aligned(bias), n_windows)
        y = unpartition(y, ws, B, *padded)
        if shift:
            y = torch.roll(y, list(ss), dims=(1, 2, 3))
        return y[:, :D, :H, :W]

    def forward(self, x, plan):
        with trace.span("swin.attn", device=x.device):
            y = self.attend(x, plan)
        x = x + y
        return x + self.mlp(_layer_norm(x, self.norm2))


class PatchMerging(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.norm = nn.LayerNorm(8 * dim, eps=NORM_EPS)
        self.reduction = nn.Linear(8 * dim, 2 * dim, bias=False)

    def forward(self, x):
        x = torch.cat([x[:, i::2, j::2, k::2] for i, j, k in
                       itertools.product(range(2), repeat=3)], dim=-1)
        return _linear(_layer_norm(x, self.norm), self.reduction)


class Stage(nn.Module):
    def __init__(self, dim, depth, heads, window):
        super().__init__()
        self.window = window
        self.blocks = nn.ModuleList(
            SwinBlock(dim, heads, window, shifted=i % 2 == 1)
            for i in range(depth))
        self.downsample = PatchMerging(dim)

    def plan(self, grid, device):
        """(window, shift, padded grid, shift mask or None) of the stage's
        grid: the mask is built once for every block of the stage."""
        ws, ss = window_in_use(grid, self.window, self.window // 2)
        padded = tuple(-(-g // w) * w for g, w in zip(grid, ws))
        mask = (shift_mask(padded, ws, ss, device)
                if len(self.blocks) > 1 and any(ss) else None)
        return ws, ss, padded, mask

    def forward(self, x):
        plan = self.plan(tuple(x.shape[1:4]), x.device)
        for block in self.blocks:
            x = block(x, plan)
        return self.downsample(x)


class SwinViT(nn.Module):
    def __init__(self, n_channels, feature_size, depths, num_heads,
                 window_size, patch_size):
        super().__init__()
        self.patch_embed = nn.Conv3d(n_channels, feature_size, patch_size,
                                     stride=patch_size)
        self.stages = nn.ModuleList(
            Stage(feature_size * 2 ** i, d, h, window_size)
            for i, (d, h) in enumerate(zip(depths, num_heads)))

    def forward(self, x):
        """The normed embedding and stage outputs, channels first."""
        x = _conv(x, self.patch_embed).permute(0, 2, 3, 4, 1)
        outs = [x]
        for stage in self.stages:
            x = stage(x)
            outs.append(x)
        return [_layer_norm(o).permute(0, 4, 1, 2, 3) for o in outs]


class ResBlock(nn.Module):
    """MONAI's UnetResBlock: kernel 3, stride 1, InstanceNorm without
    affine, LeakyReLU 0.01."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv1 = nn.Conv3d(cin, cout, 3, padding=1, bias=False)
        self.conv2 = nn.Conv3d(cout, cout, 3, padding=1, bias=False)
        self.conv3 = (nn.Conv3d(cin, cout, 1, bias=False) if cin != cout
                      else None)

    def forward(self, x):
        y = F.leaky_relu(_instance_norm(_conv(x, self.conv1)), LEAKY_SLOPE)
        y = _instance_norm(_conv(y, self.conv2))
        res = x if self.conv3 is None else _instance_norm(_conv(x,
                                                                self.conv3))
        return F.leaky_relu(y + res, LEAKY_SLOPE)


class UpBlock(nn.Module):
    """MONAI's UnetrUpBlock: transposed conv 2^3 stride 2 without bias,
    concat [up, skip], ResBlock(2 cout -> cout)."""

    def __init__(self, cin, cout):
        super().__init__()
        self.transp_conv = nn.ConvTranspose3d(cin, cout, 2, stride=2,
                                              bias=False)
        self.conv_block = ResBlock(2 * cout, cout)

    def forward(self, x, skip):
        up = _conv(x, self.transp_conv)
        return self.conv_block(torch.cat([up, skip], dim=1))


class SwinUNETR(nn.Module):
    """forward: (B, n_channels, D, H, W), each side a multiple of 32 ->
    (B, n_classes, D, H, W) float32 outputs of out_activation."""

    ndim = 3
    # Weight files hold the torch names (`models/checkpoint.py`)
    checkpoint_by_name = True

    def __init__(self, n_classes, n_channels=1, feature_size=48,
                 depths=(2, 2, 2, 2), num_heads=(3, 6, 12, 24),
                 window_size=7, patch_size=2, dim=None,
                 out_activation="softmax", dtype=torch.float32):
        super().__init__()
        depths, num_heads = tuple(depths), tuple(num_heads)
        if len(depths) != 4 or len(num_heads) != 4:
            raise ValueError(f"SwinUNETR has four stages: depths {depths} "
                             f"and num_heads {num_heads} must hold four "
                             f"entries each")
        if int(patch_size) != 2:
            raise ValueError(f"patch_size {patch_size}: the decoder's "
                             f"up-blocks take a patch of 2")
        for i, h in enumerate(num_heads):
            if (feature_size * 2 ** i) % h:
                raise ValueError(
                    f"feature_size {feature_size}: stage {i}'s dim "
                    f"{feature_size * 2 ** i} does not divide by its "
                    f"{h} heads")
        if dim is not None and int(dim) % BOX_MULTIPLE:
            raise ValueError(f"box dim {dim} is not a multiple of "
                             f"{BOX_MULTIPLE} (patch 2 x four mergings)")
        self.n_classes = int(n_classes)
        self.n_channels = int(n_channels)
        self.feature_size = F_ = int(feature_size)
        self.depths, self.num_heads = depths, num_heads
        self.window_size = int(window_size)
        self.patch_size = int(patch_size)
        self.dim = dim
        self.out_activation = out_activation
        self.out_act = get_activation(out_activation)
        self.dtype = dtype
        self.swinViT = SwinViT(n_channels, F_, depths, num_heads,
                               self.window_size, self.patch_size)
        self.encoder1 = ResBlock(n_channels, F_)
        self.encoder2 = ResBlock(F_, F_)
        self.encoder3 = ResBlock(2 * F_, 2 * F_)
        self.encoder4 = ResBlock(4 * F_, 4 * F_)
        self.encoder10 = ResBlock(16 * F_, 16 * F_)
        self.decoder5 = UpBlock(16 * F_, 8 * F_)
        self.decoder4 = UpBlock(8 * F_, 4 * F_)
        self.decoder3 = UpBlock(4 * F_, 2 * F_)
        self.decoder2 = UpBlock(2 * F_, F_)
        self.decoder1 = UpBlock(F_, F_)
        self.out_conv = nn.Conv3d(F_, n_classes, 1)

    def forward(self, x):
        if any(s % BOX_MULTIPLE for s in x.shape[2:]):
            raise ValueError(f"input sides {tuple(x.shape[2:])} are not "
                             f"multiples of {BOX_MULTIPLE}")
        x = x.to(self.dtype)
        with trace.span("swin.encoder", device=x.device):
            hidden = self.swinViT(x)
        with trace.span("swin.decoder", device=x.device):
            enc0 = self.encoder1(x)
            enc1 = self.encoder2(hidden[0])
            enc2 = self.encoder3(hidden[1])
            enc3 = self.encoder4(hidden[2])
            dec = self.encoder10(hidden[4])
            dec = self.decoder5(dec, hidden[3])
            dec = self.decoder4(dec, enc3)
            dec = self.decoder3(dec, enc2)
            dec = self.decoder2(dec, enc1)
            dec = self.decoder1(dec, enc0)
        # The out conv runs in float32 whatever the compute dtype
        return self.out_act(self.out_conv(dec.float()))


# ----------------------------------------------------------------- weights
TRUNC_STD = 0.02


def _trunc_normal(key, shape, device):
    """Normal(0, TRUNC_STD) truncated at two standard deviations, by the
    inverse CDF of a uniform draw (jax.random.truncated_normal's way)."""
    from multiplanarunet_tpu_torch.ops import prng

    lo, hi = math.erf(-2 / math.sqrt(2)), math.erf(2 / math.sqrt(2))
    u = prng.uniform(key, shape, lo, hi, device=device)
    return torch.erfinv(u) * math.sqrt(2) * TRUNC_STD


def swin_init(model, seed=0, device=None):
    """Initialise `model` in place from PRNGKey(seed), one key per
    parameter (fold_in of its index in `named_parameters` order), drawn on
    `device` (the card unless the caller names the CPU): Linear weights
    and the relative-position tables truncated normal 0.02 (two standard
    deviations), Linear biases 0, LayerNorm weight 1 and bias 0, convs
    and transposed convs torch's default (weight and bias uniform in +-1
    / sqrt(fan_in), fan_in = weight.shape[1] x the kernel's volume).
    Returns the model."""
    from multiplanarunet_tpu_torch._device import resolve_device
    from multiplanarunet_tpu_torch.ops import prng

    device = resolve_device(device)
    root = prng.PRNGKey(seed)
    owners = {f"{name}.{leaf}": m for name, m in model.named_modules()
              for leaf, _ in m.named_parameters(recurse=False)}
    state = {}
    convs = (nn.Conv3d, nn.ConvTranspose3d)
    for i, (name, p) in enumerate(model.named_parameters()):
        key = prng.fold_in(root, i)
        owner = owners[name]
        shape = tuple(p.shape)
        if isinstance(owner, convs):
            w = owner.weight
            bound = 1.0 / math.sqrt(w.shape[1] * np.prod(w.shape[2:]))
            value = prng.uniform(key, shape, -bound, bound, device=device)
        elif isinstance(owner, nn.LayerNorm):
            value = torch.full(shape, 1.0 if name.endswith("weight")
                               else 0.0, device=device)
        elif name.endswith("bias"):
            value = torch.zeros(shape, device=device)
        else:  # Linear weights and the relative-position tables
            value = _trunc_normal(key, shape, device)
        state[name] = value.float()
    model.load_state_dict(state, strict=False)
    return model
