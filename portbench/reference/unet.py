"""The upstream U-Net (MultiPlanarUNet `mpunet/models/unet.py` and its 3D
twin) written out with functional PyTorch over a flax-layout variable
tree: per encoder level [conv k^n SAME -> ReLU] x2 -> BatchNorm ->
maxpool 2, a bottom block, per decoder level [nearest 2x upsample ->
conv 2^n SAME (padded (0, 1) on the high edge) -> ReLU -> BatchNorm ->
centre-crop the skip -> concat [skip, up] -> block], a 1^n out conv and a
softmax over the classes. BatchNorm has eps 1e-3; in training it
normalises with the batch's biased variance.

`quant` is the control's precision: None computes in float32; "fp8"
computes each convolution as fp8 training does (`_Fp8Conv`): input and
kernel rounded to float8 e4m3, the output's gradient to e5m2, each under
a per-tensor scale, the sums in float32.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

BN_EPS = 1e-3
FP8_MAX = 448.0


@contextlib.contextmanager
def float32_mode(benchmark=True):
    """Float32 products and convolutions in float32, not TF32, with
    cuDNN choosing its fastest algorithm for each shape (`benchmark`);
    the process's settings come back on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = benchmark
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.benchmark) = saved


def fp8_round(t, dtype=torch.float8_e4m3fn):
    """t rounded to float8 (e4m3 by default, e5m2 for gradients) under a
    per-tensor scale that maps its largest magnitude to the format's
    largest, returned as float32."""
    amax = t.abs().amax().clamp_min(1e-30)
    scale = torch.finfo(dtype).max / amax
    return (t * scale).to(dtype).to(torch.float32) / scale


class _Fp8Conv(torch.autograd.Function):
    """A convolution as fp8 training computes it: the input and kernel
    rounded to e4m3 in the forward, the output's gradient to e5m2 in the
    backward, every product summed in float32."""

    @staticmethod
    def forward(ctx, x, w, b):
        xq, wq = fp8_round(x), fp8_round(w)
        ctx.save_for_backward(xq, wq)
        conv = F.conv2d if x.dim() == 4 else F.conv3d
        return conv(xq, wq, b)

    @staticmethod
    def backward(ctx, gy):
        xq, wq = ctx.saved_tensors
        gq = fp8_round(gy, torch.float8_e5m2)
        grad = torch.nn.grad
        if xq.dim() == 4:
            gx = grad.conv2d_input(xq.shape, wq, gq)
            gw = grad.conv2d_weight(xq, wq.shape, gq)
        else:
            gx = grad.conv3d_input(xq.shape, wq, gq)
            gw = grad.conv3d_weight(xq, wq.shape, gq)
        gb = gy.sum(dim=(0,) + tuple(range(2, gy.dim())))
        return gx, gw, gb


def _conv(x, kernel, bias, ndim, pad, quant):
    """SAME conv of channels-first x with a flax kernel (*k, I, O)."""
    w = kernel.permute((ndim + 1, ndim) + tuple(range(ndim)))
    if pad:
        x = F.pad(x, pad)
    if quant == "fp8":
        return _Fp8Conv.apply(x, w, bias)
    conv = F.conv2d if ndim == 2 else F.conv3d
    return conv(x, w, bias)


def _same_pad(k, ndim):
    lo = (k - 1) // 2
    hi = k - 1 - lo
    return (lo, hi) * ndim if k > 1 else None


def _bn(x, p, s, train):
    shape = (1, -1) + (1,) * (x.dim() - 2)
    if train:
        dims = (0,) + tuple(range(2, x.dim()))
        mean = x.mean(dim=dims)
        var = torch.clamp((x * x).mean(dim=dims) - mean * mean, min=0.0)
    else:
        mean, var = s["mean"], s["var"]
    return ((x - mean.view(shape)) * torch.rsqrt(var.view(shape) + BN_EPS)
            * p["scale"].view(shape) + p["bias"].view(shape))


def _block(x, p, s, ndim, train, quant):
    k = p["conv1"]["kernel"].shape[0]
    pad = _same_pad(k, ndim)
    x = F.relu(_conv(x, p["conv1"]["kernel"], p["conv1"]["bias"], ndim, pad,
                     quant))
    x = F.relu(_conv(x, p["conv2"]["kernel"], p["conv2"]["bias"], ndim, pad,
                     quant))
    return _bn(x, p["bn"], s["bn"], train)


def _crop(skip, up):
    sl = [slice(None), slice(None)]
    for a, b in zip(skip.shape[2:], up.shape[2:]):
        lo = (a - b) // 2
        sl.append(slice(lo, lo + b))
    return skip[tuple(sl)]


def forward(params, stats, x, depth, train=False, quant=None,
            logits=False):
    """Class probabilities (B, n_classes, *spatial) of channels-first x
    (B, C, *spatial), or with `logits` the out conv's output before the
    softmax. BatchNorm uses the batch's statistics when `train` is true,
    its running statistics (`stats`) otherwise."""
    ndim = x.dim() - 2
    pool = F.max_pool2d if ndim == 2 else F.max_pool3d
    skips = []
    for i in range(depth):
        x = _block(x, params[f"encoder_L{i}"], stats[f"encoder_L{i}"], ndim,
                   train, quant)
        skips.append(x)
        x = pool(x, 2, 2)
    x = _block(x, params["bottom"], stats["bottom"], ndim, train, quant)
    for i in range(depth):
        up = params[f"decoder_L{i}_conv_up"]
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        x = F.relu(_conv(x, up["kernel"], up["bias"], ndim, (0, 1) * ndim,
                         quant))
        x = _bn(x, params[f"decoder_L{i}_bn_up"],
                stats.get(f"decoder_L{i}_bn_up"), train)
        x = torch.cat([_crop(skips[-(i + 1)], x), x], dim=1)
        x = _block(x, params[f"decoder_L{i}"], stats[f"decoder_L{i}"], ndim,
                   train, quant)
    out = params["out_conv"]
    z = _conv(x, out["kernel"], out["bias"], ndim, None, quant)
    return z if logits else torch.softmax(z, dim=1)


def sparse_ce(probs, y, w):
    """The upstream loss: per sample the mean over its voxels of
    -log(p[target]) (p clipped to [1e-8, 1 - 1e-8]), times the sample
    weight, averaged over the batch. probs (B, C, *spatial), y (B,
    *spatial) integer, w (B,)."""
    p = probs.gather(1, y.long().unsqueeze(1)).squeeze(1)
    ce = -torch.log(torch.clamp(p, 1e-8, 1.0 - 1e-8))
    per = ce.flatten(1).mean(dim=1)
    return (per * w).mean()


def leaves(tree, prefix=()):
    """[(path, tensor)] of a nested dict, in insertion order."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += leaves(v, prefix + (k,))
        else:
            out.append((prefix + (k,), v))
    return out


def rebuild(flat):
    """The nested dict of [(path, tensor)] (`leaves`' inverse)."""
    tree = {}
    for path, v in flat:
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    return tree


def train_steps(variables, batches, depth, opt, quant=None, state=None):
    """The upstream training step (forward in train mode, the loss,
    backward, optax's Adam) over `batches`, from `variables` (the tree
    the program started from; not changed) and Adam's `state` (mu, nu,
    the count of steps before; None: zeros and 0). Returns (losses, the
    first step's gradient {path: tensor}, the parameters after the last
    step {path: tensor}). opt: (lr, b1, b2, eps)."""
    lr, b1, b2, eps = opt
    flat = [(p, v.detach().clone().float().requires_grad_(True))
            for p, v in leaves(variables["params"])]
    stats = variables["batch_stats"]
    if state is None:
        mu = [torch.zeros_like(v) for _, v in flat]
        nu = [torch.zeros_like(v) for _, v in flat]
        t0 = 0
    else:
        mu = [v.detach().clone().float() for _, v in leaves(state[0])]
        nu = [v.detach().clone().float() for _, v in leaves(state[1])]
        t0 = int(state[2])
    losses, first = [], None
    for t, (x, y, w) in enumerate(batches, start=t0 + 1):
        params = rebuild(flat)
        xc = x.float().movedim(-1, 1)
        yc = y[..., 0] if y.shape[-1] == 1 else y
        probs = forward(params, stats, xc, depth, train=True, quant=quant)
        loss = sparse_ce(probs, yc, torch.as_tensor(w, dtype=torch.float32,
                                                    device=xc.device))
        grads = torch.autograd.grad(loss, [v for _, v in flat])
        losses.append(float(loss.detach()))
        if first is None:
            first = {p: g.detach().clone() for (p, _), g in zip(flat, grads)}
        with torch.no_grad():
            for i, ((_, v), g) in enumerate(zip(flat, grads)):
                mu[i].mul_(b1).add_((1 - b1) * g)
                nu[i].mul_(b2).add_((1 - b2) * g * g)
                m_hat = mu[i] / (1 - b1 ** t)
                n_hat = nu[i] / (1 - b2 ** t)
                v.sub_(lr * m_hat / (torch.sqrt(n_hat) + eps))
        del probs, loss, grads
    return losses, first, {p: v.detach() for p, v in flat}
