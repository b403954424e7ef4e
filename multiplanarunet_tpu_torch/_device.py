"""The CUDA device and its numeric modes.

`require_cuda()` is the one place the port asks for the card: it raises
`CudaUnavailableError` when there is none, and sets the float32 modes
explicitly. TF32 is off for both matrix products and cuDNN convolutions,
so a float32 run on the card computes in float32 as the CPU reference
does (cuDNN would otherwise take float32 convolutions in TF32).
"""

from __future__ import annotations

import torch


class CudaUnavailableError(RuntimeError):
    """No CUDA device is visible to torch."""


class TooFewDevicesError(RuntimeError):
    """More cards were asked for than torch sees."""


def require_cuda(index=0):
    """The torch.device of CUDA card `index`, with TF32 disabled."""
    if not torch.cuda.is_available():
        raise CudaUnavailableError(
            "torch.cuda.is_available() is False: the port's inference path "
            "runs on an NVIDIA GPU (its CPU code paths are for tests)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", index)


def require_devices(n):
    """Raise TooFewDevicesError unless at least `n` cards are visible
    (checked before any process or device work starts)."""
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if visible < int(n):
        raise TooFewDevicesError(f"{int(n)} devices asked, {visible} "
                                 f"visible")


def resolve_device(device=None):
    """The torch.device a library entry point runs on: the card for None
    (the default), 'cuda' or 'cuda:N', each through require_cuda, so a
    missing card raises and never turns into the CPU; any other device
    (the CPU, for tests) as given."""
    if device is None:
        return require_cuda()
    device = torch.device(device)
    if device.type == "cuda":
        return require_cuda(device.index or 0)
    return device
