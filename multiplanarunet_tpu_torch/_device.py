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


def require_cuda(index=0):
    """The torch.device of CUDA card `index`, with TF32 disabled."""
    if not torch.cuda.is_available():
        raise CudaUnavailableError(
            "torch.cuda.is_available() is False: the port's inference path "
            "runs on an NVIDIA GPU (its CPU code paths are for tests)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", index)
