"""Swin UNETR (MONAI's `SwinUNETR`, v1, as Tang et al. train it on BTCV)
written out with functional PyTorch over a dict of named float32 tensors,
and its training step (DiceCE loss, AdamW), for the training cell's
check and the CPU tests.

The names are those of the parameters of a module tree laid out as
MONAI's: `swinViT.patch_embed.{weight,bias}`,
`swinViT.stages.<i>.blocks.<j>.{norm1,attn.qkv,attn.proj,norm2,
mlp.linear1,mlp.linear2}.{weight,bias}` with
`attn.relative_position_bias_table`, `swinViT.stages.<i>.downsample.
{norm.weight,norm.bias,reduction.weight}`, the residual blocks
`encoder1/2/3/4/10.conv{1,2,3}.weight`, the up-blocks
`decoder5..1.transp_conv.weight` and `.conv_block.conv{1,2,3}.weight`,
and `out_conv.{weight,bias}`; every array in torch's layout.

The forward, on channels-first x (B, C, D, H, W) with sides divisible by
32: the patch embedding (conv k = s = 2), then four stages of Swin
blocks and a patch merging; in each block LayerNorm, zero padding to a
multiple of the window, in odd blocks a cyclic shift by window // 2 and
a -100 mask between the 27 regions of the padded grid, windowed
attention (q k^T / sqrt(head_dim) + B_rel (+ mask), softmax, @ v) and the
projection, the reverse, then LayerNorm and the GELU MLP; patch merging
concatenates the 2x2x2 neighbours in (i, j, k) order, LayerNorm, linear.
A stage whose grid is no larger than the window attends over the whole
grid, unshifted, with the relative offsets of that window. Each stage's
output and the embedding are normed without affine for the decoder:
residual blocks of conv 3^3, InstanceNorm (eps 1e-5), LeakyReLU 0.01,
up-blocks of a transposed conv 2^3 stride 2, the conv 1^3 out and the
softmax over the classes.

`quant` is the control's precision: None computes in float32 (TF32 off);
"fp8" computes each convolution and linear layer as fp8 training does:
input and weight rounded to float8 e4m3, the output's gradient to e5m2,
each under a per-tensor scale, the sums in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.unet import float32_mode, fp8_round

EPS = 1e-5
STAGES = 4


class _Fp8(torch.autograd.Function):
    """op(x, w) as fp8 training computes it: x and w rounded to e4m3 in
    the forward, the output's gradient to e5m2 in the backward, every
    product summed in float32."""

    @staticmethod
    def forward(ctx, x, w, op):
        xq, wq = fp8_round(x), fp8_round(w)
        ctx.save_for_backward(xq, wq)
        ctx.op = op
        return op(xq, wq)

    @staticmethod
    def backward(ctx, gy):
        xq, wq = ctx.saved_tensors
        gq = fp8_round(gy, torch.float8_e5m2)
        with torch.enable_grad():
            xr = xq.detach().requires_grad_(True)
            wr = wq.detach().requires_grad_(True)
            gx, gw = torch.autograd.grad(ctx.op(xr, wr), (xr, wr), gq)
        return gx, gw, None


def _apply(op, x, w, b, quant):
    y = _Fp8.apply(x, w, op) if quant == "fp8" else op(x, w)
    return y if b is None else y + b


def linear(x, p, name, quant):
    return _apply(F.linear, x, p[name + ".weight"], p.get(name + ".bias"),
                  quant)


def conv(x, p, name, quant, stride=1, pad=0, transposed=False):
    if transposed:
        def op(a, w):
            return F.conv_transpose3d(a, w, stride=stride)
    else:
        def op(a, w):
            return F.conv3d(a, w, stride=stride, padding=pad)
    b = p.get(name + ".bias")
    return _apply(op, x, p[name + ".weight"],
                  None if b is None else b.view(1, -1, 1, 1, 1), quant)


def layer_norm(x, weight=None, bias=None):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (x - mean) / torch.sqrt(var + EPS)
    return y if weight is None else y * weight + bias


def instance_norm(x):
    dims = (2, 3, 4)
    mean = x.mean(dim=dims, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=dims, keepdim=True)
    return (x - mean) / torch.sqrt(var + EPS)


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def leaky_relu(x):
    return torch.where(x >= 0, x, 0.01 * x)


def region_ids(padded, ws, ss, device):
    """Each token's region of the padded grid (D, H, W): along each axis
    0 below P - w, 1 from P - w to P - s, 2 from P - s; the id mixes the
    three axes."""
    ids = torch.zeros(padded, dtype=torch.long, device=device)
    for a, (P, w, s) in enumerate(zip(padded, ws, ss)):
        c = torch.arange(P, device=device)
        r = (c >= P - w).long() + (c >= P - s).long()
        shape = [1, 1, 1]
        shape[a] = P
        ids = ids * 3 + r.view(shape)
    return ids


def to_windows(x, ws):
    """(B, D, H, W, C) -> (B, nW, N, C): windows in (d, h, w) order, tokens
    in (i, j, k) order inside each."""
    B, D, H, W, C = x.shape
    x = x.reshape(B, D // ws[0], ws[0], H // ws[1], ws[1], W // ws[2],
                  ws[2], C)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(B, -1, ws[0] * ws[1] * ws[2], C)


def from_windows(w, ws, D, H, W):
    B, _, _, C = w.shape
    x = w.reshape(B, D // ws[0], H // ws[1], W // ws[2], ws[0], ws[1],
                  ws[2], C)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(B, D, H, W, C)


def rel_bias(table, ws, window):
    """(heads, N, N): table rows of each pair's offset (t1 - t2) in the
    (2 window - 1)^3 grid of offsets."""
    t = torch.stack(torch.meshgrid(*[torch.arange(w, device=table.device)
                                     for w in ws], indexing="ij"), -1)
    t = t.reshape(-1, 3)
    d = t[:, None, :] - t[None, :, :] + (window - 1)
    side = 2 * window - 1
    row = d[..., 0] * side * side + d[..., 1] * side + d[..., 2]
    return table[row].permute(2, 0, 1)


def swin_block(x, p, name, heads, window, shifted, quant):
    B, D, H, W, C = x.shape
    ws = tuple(g if g <= window else window for g in (D, H, W))
    shift = tuple(0 if g <= window else window // 2 for g in (D, H, W))
    shifted = shifted and any(shift)
    padded = tuple(math.ceil(g / w) * w for g, w in zip((D, H, W), ws))
    y = layer_norm(x, p[name + ".norm1.weight"], p[name + ".norm1.bias"])
    y = F.pad(y, (0, 0, 0, padded[2] - W, 0, padded[1] - H,
                  0, padded[0] - D))
    bias = rel_bias(p[name + ".attn.relative_position_bias_table"], ws,
                    window)[None, None]                  # (1, 1, h, N, N)
    if shifted:
        y = torch.roll(y, shifts=[-s for s in shift], dims=(1, 2, 3))
        ids = to_windows(region_ids(padded, ws, shift, x.device)[
            None, ..., None], ws)[0, ..., 0]             # (nW, N)
        mask = torch.where(ids[:, :, None] == ids[:, None, :], 0.0, -100.0)
        bias = bias + mask[None, :, None]                # (1, nW, h, N, N)
    win = to_windows(y, ws)                              # (B, nW, N, C)
    nW, N = win.shape[1], win.shape[2]
    hd = C // heads
    qkv = linear(win, p, name + ".attn.qkv", quant)
    qkv = qkv.reshape(B, nW, N, 3, heads, hd).permute(3, 0, 1, 4, 2, 5)
    q, k, v = qkv[0], qkv[1], qkv[2]                     # (B, nW, h, N, hd)
    scores = q @ k.transpose(-1, -2) / math.sqrt(hd) + bias
    out = torch.softmax(scores, dim=-1) @ v
    out = out.permute(0, 1, 3, 2, 4).reshape(B, nW, N, C)
    out = linear(out, p, name + ".attn.proj", quant)
    y = from_windows(out, ws, *padded)
    if shifted:
        y = torch.roll(y, shifts=list(shift), dims=(1, 2, 3))
    x = x + y[:, :D, :H, :W]
    z = layer_norm(x, p[name + ".norm2.weight"], p[name + ".norm2.bias"])
    z = linear(gelu(linear(z, p, name + ".mlp.linear1", quant)), p,
               name + ".mlp.linear2", quant)
    return x + z


def merge(x, p, name, quant):
    parts = [x[:, i::2, j::2, k::2] for i in (0, 1) for j in (0, 1)
             for k in (0, 1)]
    x = torch.cat(parts, dim=-1)
    x = layer_norm(x, p[name + ".norm.weight"], p[name + ".norm.bias"])
    return linear(x, p, name + ".reduction", quant)


def res_block(x, p, name, quant):
    y = leaky_relu(instance_norm(conv(x, p, name + ".conv1", quant,
                                      pad=1)))
    y = instance_norm(conv(y, p, name + ".conv2", quant, pad=1))
    if name + ".conv3.weight" in p:
        x = instance_norm(conv(x, p, name + ".conv3", quant))
    return leaky_relu(y + x)


def up_block(x, skip, p, name, quant):
    up = conv(x, p, name + ".transp_conv", quant, stride=2, transposed=True)
    return res_block(torch.cat([up, skip], dim=1), p, name + ".conv_block",
                     quant)


def config_of(p):
    """(feature size, depths, heads, window) read off the tensors' names
    and shapes."""
    F_ = p["swinViT.patch_embed.weight"].shape[0]
    depths, heads = [], []
    for i in range(STAGES):
        n = 0
        while f"swinViT.stages.{i}.blocks.{n}.norm1.weight" in p:
            n += 1
        depths.append(n)
        heads.append(p[f"swinViT.stages.{i}.blocks.0.attn."
                       f"relative_position_bias_table"].shape[1])
    rows = p["swinViT.stages.0.blocks.0.attn.relative_position_bias_table"
             ].shape[0]
    window = (round(rows ** (1 / 3)) + 1) // 2
    return F_, depths, heads, window


def forward(p, x, quant=None, logits=False):
    """Class probabilities (B, n_classes, D, H, W) of channels-first x, or
    with `logits` the out conv's output."""
    _, depths, heads, window = config_of(p)
    t = conv(x, p, "swinViT.patch_embed", quant, stride=2)
    t = t.permute(0, 2, 3, 4, 1)
    hidden = [t]
    for i in range(STAGES):
        for j in range(depths[i]):
            t = swin_block(t, p, f"swinViT.stages.{i}.blocks.{j}", heads[i],
                           window, j % 2 == 1, quant)
        t = merge(t, p, f"swinViT.stages.{i}.downsample", quant)
        hidden.append(t)
    hidden = [layer_norm(h).permute(0, 4, 1, 2, 3) for h in hidden]
    enc0 = res_block(x, p, "encoder1", quant)
    enc1 = res_block(hidden[0], p, "encoder2", quant)
    enc2 = res_block(hidden[1], p, "encoder3", quant)
    enc3 = res_block(hidden[2], p, "encoder4", quant)
    d = res_block(hidden[4], p, "encoder10", quant)
    d = up_block(d, hidden[3], p, "decoder5", quant)
    d = up_block(d, enc3, p, "decoder4", quant)
    d = up_block(d, enc2, p, "decoder3", quant)
    d = up_block(d, enc1, p, "decoder2", quant)
    d = up_block(d, enc0, p, "decoder1", quant)
    z = conv(d, p, "out_conv", quant)
    return z if logits else torch.softmax(z, dim=1)


def dice_ce(probs, y, w):
    """MONAI's DiceCELoss over probabilities (squared_pred, smooth_nr 0,
    smooth_dr 1e-6) with sample weights: per sample the mean over its
    voxels of -log(p[target]) (p clipped to [1e-8, 1 - 1e-8]) plus the
    mean over classes of 1 - 2 sum(p g) / (sum(p^2) + sum(g) + 1e-6),
    times the weight, averaged over the batch. probs (B, C, *spatial), y
    (B, *spatial) integer, w (B,)."""
    C = probs.shape[1]
    g = (y.long().unsqueeze(1) == torch.arange(
        C, device=y.device).view(1, -1, 1, 1, 1)).float()
    pt = (probs * g).sum(dim=1)
    ce = -torch.log(torch.clamp(pt, 1e-8, 1.0 - 1e-8)).flatten(1).mean(1)
    inter = (probs * g).flatten(2).sum(-1)
    denom = (probs * probs).flatten(2).sum(-1) + g.flatten(2).sum(-1)
    dice = (1.0 - 2.0 * inter / (denom + 1e-6)).mean(dim=1)
    return ((ce + dice) * w).mean()


def train_steps(params, batches, opt, quant=None, state=None):
    """Training steps (forward, DiceCE, backward, AdamW as optax's adamw)
    over `batches` [(x (B, D, H, W, C), y (B, D, H, W, 1), w (B,))], from
    `params` {name: tensor} (not changed) and AdamW's `state` (mu, nu as
    {name: tensor}, the count of steps before; None: zeros and 0), in
    float32 with TF32 off. Returns (losses, the first step's gradient
    {name: tensor}, the parameters after the last step {name: tensor}).
    opt: (lr, b1, b2, eps, weight decay)."""
    lr, b1, b2, eps, wd = opt
    names = list(params)
    flat = {n: params[n].detach().clone().float().requires_grad_(True)
            for n in names}
    if state is None:
        mu = {n: torch.zeros_like(v) for n, v in flat.items()}
        nu = {n: torch.zeros_like(v) for n, v in flat.items()}
        t0 = 0
    else:
        mu = {n: state[0][n].detach().clone().float() for n in names}
        nu = {n: state[1][n].detach().clone().float() for n in names}
        t0 = int(state[2])
    losses, first = [], None
    with float32_mode(benchmark=False):
        for t, (x, y, w) in enumerate(batches, start=t0 + 1):
            xc = x.float().movedim(-1, 1)
            yc = y[..., 0] if y.shape[-1] == 1 else y
            probs = forward(flat, xc, quant=quant)
            loss = dice_ce(probs, yc, torch.as_tensor(
                w, dtype=torch.float32, device=xc.device))
            grads = torch.autograd.grad(loss, [flat[n] for n in names])
            losses.append(float(loss.detach()))
            if first is None:
                first = {n: g.detach().clone() for n, g in zip(names, grads)}
            with torch.no_grad():
                for n, g in zip(names, grads):
                    mu[n].mul_(b1).add_((1 - b1) * g)
                    nu[n].mul_(b2).add_((1 - b2) * g * g)
                    m_hat = mu[n] / (1 - b1 ** t)
                    n_hat = nu[n] / (1 - b2 ** t)
                    flat[n].sub_(lr * (m_hat / (torch.sqrt(n_hat) + eps)
                                       + wd * flat[n]))
            del probs, loss, grads
    return losses, first, {n: v.detach() for n, v in flat.items()}


def layout(build):
    """[(name, shape, kind)] of the configuration's tensors, kind one of
    "conv" (weight or bias of a conv or transposed conv), "linear",
    "linear_bias", "table" (a relative-position table) and "norm_weight"
    / "norm_bias" (LayerNorm)."""
    F_ = int(build["feature_size"])
    cin = int(build["n_channels"])
    window = int(build["window_size"])
    p = int(build["patch_size"])
    out = [("swinViT.patch_embed.weight", (F_, cin, p, p, p), "conv"),
           ("swinViT.patch_embed.bias", (F_,), "conv")]

    def lin(name, o, i, bias=True):
        out.append((name + ".weight", (o, i), "linear"))
        if bias:
            out.append((name + ".bias", (o,), "linear_bias"))

    def norm(name, c):
        out.append((name + ".weight", (c,), "norm_weight"))
        out.append((name + ".bias", (c,), "norm_bias"))

    for i, (depth, heads) in enumerate(zip(build["depths"],
                                           build["num_heads"])):
        C = F_ * 2 ** i
        for j in range(int(depth)):
            b = f"swinViT.stages.{i}.blocks.{j}"
            norm(b + ".norm1", C)
            lin(b + ".attn.qkv", 3 * C, C)
            lin(b + ".attn.proj", C, C)
            out.append((b + ".attn.relative_position_bias_table",
                        ((2 * window - 1) ** 3, int(heads)), "table"))
            norm(b + ".norm2", C)
            lin(b + ".mlp.linear1", 4 * C, C)
            lin(b + ".mlp.linear2", C, 4 * C)
        d = f"swinViT.stages.{i}.downsample"
        norm(d + ".norm", 8 * C)
        lin(d + ".reduction", 2 * C, 8 * C, bias=False)

    def res(name, ci, co):
        out.append((name + ".conv1.weight", (co, ci, 3, 3, 3), "conv"))
        out.append((name + ".conv2.weight", (co, co, 3, 3, 3), "conv"))
        if ci != co:
            out.append((name + ".conv3.weight", (co, ci, 1, 1, 1), "conv"))

    res("encoder1", cin, F_)
    res("encoder2", F_, F_)
    res("encoder3", 2 * F_, 2 * F_)
    res("encoder4", 4 * F_, 4 * F_)
    res("encoder10", 16 * F_, 16 * F_)
    for k, name in zip(range(4, -1, -1), ("decoder5", "decoder4",
                                          "decoder3", "decoder2",
                                          "decoder1")):
        ci, co = F_ * 2 ** k, F_ * 2 ** max(k - 1, 0)
        out.append((name + ".transp_conv.weight", (ci, co, 2, 2, 2),
                    "conv"))
        res(name + ".conv_block", 2 * co, co)
    nc = int(build["n_classes"])
    out.append(("out_conv.weight", (nc, F_, 1, 1, 1), "conv"))
    out.append(("out_conv.bias", (nc,), "conv"))
    return out
