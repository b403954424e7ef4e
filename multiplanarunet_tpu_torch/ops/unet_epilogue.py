"""The epilogue of the U-Net's convolutions in eval mode: the conv's bias,
the activation (ReLU or linear) and an eval BatchNorm in one pass.

`unet_epilogue(x, bias, relu, bn)` takes a conv's output computed without
its bias, x of shape (N, C, *spatial), and returns

    act(x + bias)                      (bn None)
    BatchNorm(act(x + bias))           (bn = (mean, var, weight, beta, eps))

with the roundings of the ops it stands for (`models/unet.py`'s eval
forward): the bias cast to x's dtype and added in it, the activation in
x's dtype, and the BatchNorm of the running statistics computed in
float32 and cast back to x's dtype. On a CUDA device it launches
`csrc/unet_epilogue.cu` on x in place and returns x: x must be a bf16
tensor dense in NCHW order or in channels-last order (N, *spatial, C in
memory, as cuDNN may answer) and the per-channel tensors contiguous
float32 of C values on x's device; anything else raises. Each launch adds one to
`unet_epilogue.launches` and to the trace counter `unet.epilogue`, and a
launch on a channels-last output (rows of one element) one to
`unet.epilogue_cl`. On the
CPU it runs `unet_epilogue_reference`, the plain version: those ops one
by one, in any floating dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from multiplanarunet_tpu_torch.ops._build import KernelLaunchError, kernels
from multiplanarunet_tpu_torch.utils import trace


def unet_epilogue_reference(x, bias, relu, bn=None):
    """Plain PyTorch version of the kernel: x + bias in x's dtype, ReLU
    (relu True) or nothing, then with bn = (mean, var, weight, beta, eps)
    the eval BatchNorm in float32, cast back to x's dtype. Returns a new
    tensor."""
    y = x + bias.to(x.dtype).view((1, -1) + (1,) * (x.dim() - 2))
    if relu:
        y = F.relu(y)
    if bn is None:
        return y
    mean, var, weight, beta, eps = bn
    return F.batch_norm(y.float(), mean, var, weight, beta, False, 0.0,
                        eps).to(x.dtype)


def row_length(x):
    """Elements a row of one channel in x's memory order, as the kernel
    takes it: the spatial size where x (N, C, *spatial) is contiguous, 1
    where it is dense channels-last (N, *spatial, C in memory). Raises on
    any other layout."""
    if x.dim() >= 2:
        if x.is_contiguous():
            return math.prod(x.shape[2:])
        if x.movedim(1, -1).is_contiguous():
            return 1
    raise ValueError(f"unet_epilogue takes an (N, C, *spatial) tensor "
                     f"dense in NCHW or channels-last order; got shape "
                     f"{tuple(x.shape)}, strides {x.stride()}")


def _channel_values(x, name, t):
    if (t.dtype != torch.float32 or t.device != x.device
            or not t.is_contiguous() or t.numel() != x.shape[1]):
        raise ValueError(f"unet_epilogue: {name} must be a contiguous "
                         f"float32 tensor of {x.shape[1]} values on "
                         f"{x.device}; got {t.dtype}, {tuple(t.shape)} on "
                         f"{t.device}")
    return t.data_ptr()


def unet_epilogue(x, bias, relu, bn=None):
    """The epilogue of a conv's output x (see the module's docstring): in
    place by the kernel on a CUDA device (returns x), by the plain
    version on the CPU."""
    if x.device.type == "cpu":
        return unet_epilogue_reference(x, bias, relu, bn)
    if x.device.type != "cuda" or x.dtype != torch.bfloat16:
        raise ValueError(f"unet_epilogue runs on the CPU, or on a CUDA "
                         f"device in bfloat16; got {x.dtype} on {x.device}")
    row_len = row_length(x)
    if x.numel() == 0:
        return x
    ptrs = [_channel_values(x, "bias", bias)]
    if bn is None:
        ptrs += [None] * 4
        eps = 0.0
    else:
        *stats, eps = bn
        ptrs += [_channel_values(x, name, t) for name, t in
                 zip(("mean", "var", "weight", "beta"), stats)]
    fn = kernels().unet_epilogue
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), x.numel() // row_len, row_len, x.shape[1],
                 ptrs[0], int(bool(relu)), *ptrs[1:], float(eps), stream)
    if err != 0:
        raise KernelLaunchError(f"unet_epilogue kernel launch failed: "
                                f"cudaError {err}")
    unet_epilogue.launches += 1
    trace.count("unet.epilogue")
    if row_len == 1:
        trace.count("unet.epilogue_cl")
    return x


unet_epilogue.launches = 0
