"""Import hygiene and device contracts of the PyTorch port (CPU only)."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from multiplanarunet_tpu_torch import _device
from multiplanarunet_tpu_torch.ops import _build
from multiplanarunet_tpu_torch.ops.shear_pass import shear_pass
from multiplanarunet_tpu_torch.ops.shear_plan import plan_affine_resample

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SLICE_MODULES = [
    "multiplanarunet_tpu_torch",
    "multiplanarunet_tpu_torch._device",
    "multiplanarunet_tpu_torch.ops.geometry",
    "multiplanarunet_tpu_torch.ops.shear_plan",
    "multiplanarunet_tpu_torch.ops._build",
    "multiplanarunet_tpu_torch.ops.shear_pass",
    "multiplanarunet_tpu_torch.ops.shear",
    "multiplanarunet_tpu_torch.models.unet",
    "multiplanarunet_tpu_torch.models.fusion_model",
    "multiplanarunet_tpu_torch.models.checkpoint",
    "multiplanarunet_tpu_torch.image.volume_sampler",
    "multiplanarunet_tpu_torch.utils.fusion.fuse_and_predict",
]


def test_slice_imports_no_jax_flax_sklearn_or_jax_package():
    """In a fresh interpreter (this one already holds jax): importing every
    slice module loads none of jax, flax, sklearn, yaml or the JAX package,
    and builds no kernel."""
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "banned = ('jax', 'flax', 'sklearn', 'yaml', 'multiplanarunet_tpu')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in banned)\n"
        "assert not bad, bad\n"
        "from multiplanarunet_tpu_torch.ops import _build\n"
        "assert _build.kernels.cache_info().currsize == 0\n"
        "print('clean')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def test_shear_pass_on_cpu_uses_plain_version_without_counting():
    plan = plan_affine_resample(np.eye(3) * 0.9, np.ones(3), (6, 5, 4),
                                (6, 5, 4))
    A = torch.rand(plan.src_t_shape + (2,))
    before = shear_pass.launches
    out = shear_pass(A.contiguous(), plan.ops[0], "linear")
    assert out.device.type == "cpu"
    assert shear_pass.launches == before == 0
    assert _build.kernels.cache_info().currsize == 0  # nothing was built


def test_require_cuda_raises_without_a_card():
    assert not torch.cuda.is_available()
    with pytest.raises(_device.CudaUnavailableError):
        _device.require_cuda()


def test_build_raises_named_error_without_nvcc(tmp_path, monkeypatch):
    """No nvcc anywhere: a named error, no fallback and no library."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "empty_bin"))
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.build(build_dir=tmp_path / "kernels")
    assert not (tmp_path / "kernels").exists()
