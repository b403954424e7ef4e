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
from tests.torch_projects import torch_threads  # noqa: F401


REPO = Path(__file__).resolve().parents[1]
SLICE_MODULES = [
    "multiplanarunet_tpu_torch",
    "multiplanarunet_tpu_torch._device",
    "multiplanarunet_tpu_torch.ops.geometry",
    "multiplanarunet_tpu_torch.ops.shear_plan",
    "multiplanarunet_tpu_torch.ops._build",
    "multiplanarunet_tpu_torch.ops.shear_pass",
    "multiplanarunet_tpu_torch.ops.prng",
    "multiplanarunet_tpu_torch.ops.shear",
    "multiplanarunet_tpu_torch.ops.interp",
    "multiplanarunet_tpu_torch.models.unet",
    "multiplanarunet_tpu_torch.models.fusion_model",
    "multiplanarunet_tpu_torch.models.checkpoint",
    "multiplanarunet_tpu_torch.models.model_init",
    "multiplanarunet_tpu_torch.image.volume_sampler",
    "multiplanarunet_tpu_torch.image.image_pair",
    "multiplanarunet_tpu_torch.image.image_pair_loader",
    "multiplanarunet_tpu_torch.io.nifti",
    "multiplanarunet_tpu_torch.preprocessing.scaling",
    "multiplanarunet_tpu_torch.evaluate.metrics",
    "multiplanarunet_tpu_torch.hyperparameters.yaml_reader",
    "multiplanarunet_tpu_torch.hyperparameters.hparams",
    "multiplanarunet_tpu_torch.logging.loggers",
    "multiplanarunet_tpu_torch.logging.log_results",
    "multiplanarunet_tpu_torch.errors.image_errors",
    "multiplanarunet_tpu_torch.utils.utils",
    "multiplanarunet_tpu_torch.utils.fusion.fuse_and_predict",
    "multiplanarunet_tpu_torch.bin.predict",
    "multiplanarunet_tpu_torch.bin.mp",
    "multiplanarunet_tpu_torch.evaluate.losses",
    "multiplanarunet_tpu_torch.errors.implementation_change_errors",
    "multiplanarunet_tpu_torch.ops.elastic",
    "multiplanarunet_tpu_torch.augmentation.augmenters",
    "multiplanarunet_tpu_torch.sequences",
    "multiplanarunet_tpu_torch.sequences.base_sequence",
    "multiplanarunet_tpu_torch.sequences.multi_planar",
    "multiplanarunet_tpu_torch.sequences.utils",
    "multiplanarunet_tpu_torch.image.auditor",
    "multiplanarunet_tpu_torch.image.queue.queues",
    "multiplanarunet_tpu_torch.preprocessing.data_preparation_funcs",
    "multiplanarunet_tpu_torch.callbacks.callbacks",
    "multiplanarunet_tpu_torch.callbacks.validation",
    "multiplanarunet_tpu_torch.callbacks.funcs",
    "multiplanarunet_tpu_torch.train.optimizers",
    "multiplanarunet_tpu_torch.train.utils",
    "multiplanarunet_tpu_torch.train.train_step",
    "multiplanarunet_tpu_torch.train.trainer",
    "multiplanarunet_tpu_torch.bin.train",
    "multiplanarunet_tpu_torch.utils.fusion.fusion_training",
    "multiplanarunet_tpu_torch.bin.init_project",
    "multiplanarunet_tpu_torch.bin.toy_data",
    "multiplanarunet_tpu_torch.bin.train_fusion",
    "multiplanarunet_tpu_torch.bin.summary",
    "multiplanarunet_tpu_torch.bin.cv_split",
    "multiplanarunet_tpu_torch.bin.cv_experiment",
    "multiplanarunet_tpu_torch.bin.version",
    "multiplanarunet_tpu_torch.parallel",
    "multiplanarunet_tpu_torch.parallel.volume_pool",
    "multiplanarunet_tpu_torch.image.queue",
    "multiplanarunet_tpu_torch.models.unet3d",
    "multiplanarunet_tpu_torch.sequences.iso_3d",
    "multiplanarunet_tpu_torch.sequences.patches_3d",
    "multiplanarunet_tpu_torch.bin.predict_3D",
    "multiplanarunet_tpu_torch.models",
    "multiplanarunet_tpu_torch.models.multitask_unet",
    "multiplanarunet_tpu_torch.sequences.multi_task",
    "multiplanarunet_tpu_torch.hyperparameters.yaml_writer",
    "multiplanarunet_tpu_torch.bin.branch",
    "multiplanarunet_tpu_torch.utils.plotting",
    "multiplanarunet_tpu_torch.utils.system",
    "multiplanarunet_tpu_torch.utils.conv_arithmetics",
    "multiplanarunet_tpu_torch.utils.decorators",
    "multiplanarunet_tpu_torch.preprocessing.input_prep",
    "multiplanarunet_tpu_torch.sequences.simple_sequences",
    "multiplanarunet_tpu_torch.bin.trim_channels",
    "multiplanarunet_tpu_torch.bin.convert_weights",
    "multiplanarunet_tpu_torch.bin.export_weights",
    "multiplanarunet_tpu_torch.bin.run_tests",
    "multiplanarunet_tpu_torch.callbacks",
    "multiplanarunet_tpu_torch.train",
    "multiplanarunet_tpu_torch.preprocessing",
    "multiplanarunet_tpu_torch.utils",
    "multiplanarunet_tpu_torch.utils.fusion",
    "multiplanarunet_tpu_torch.evaluate",
    "multiplanarunet_tpu_torch.hyperparameters",
    "multiplanarunet_tpu_torch.image",
    "multiplanarunet_tpu_torch.io",
    "multiplanarunet_tpu_torch.errors",
    "multiplanarunet_tpu_torch.logging",
    "multiplanarunet_tpu_torch.augmentation",
    "multiplanarunet_tpu_torch.ops",
]
BANNED = ("jax", "flax", "optax", "yaml", "pandas", "sklearn", "nibabel",
          "matplotlib", "h5py", "multiplanarunet_tpu")


def test_slice_imports_no_jax_flax_sklearn_or_jax_package():
    """In a fresh interpreter (this one already holds jax): importing every
    port module loads none of the banned packages, and builds no
    kernel."""
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{BANNED!r})\n"
        "assert not bad, bad\n"
        "from multiplanarunet_tpu_torch.ops import _build\n"
        "assert _build.kernels.cache_info().currsize == 0\n"
        "print('clean')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def test_port_runs_with_banned_packages_blocked(tmp_path):
    """With jax, flax, optax, yaml, pandas, sklearn, nibabel, matplotlib,
    h5py and the JAX package made unimportable (as on a machine that
    lacks them), every port module imports, `mp <script> --help` runs for
    every script, and `mp trim_channels` trims a 2-channel NIfTI."""
    from multiplanarunet_tpu_torch.io import nifti

    vol = np.arange(4 * 5 * 3 * 2, dtype=np.float32).reshape(4, 5, 3, 2)
    nifti.save(vol, tmp_path / "a.nii.gz", np.eye(4))
    code = (
        "import importlib, runpy, sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        f"        if name.split('.')[0] in {BANNED!r}:\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from multiplanarunet_tpu_torch.bin.mp import get_scripts\n"
        "assert len(get_scripts()) == 15, get_scripts()\n"
        "from multiplanarunet_tpu_torch.bin import mp\n"
        f"mp.entry_func(['trim_channels', '--folder', {str(tmp_path)!r},\n"
        "               '--channels', '1'])\n"
        "for script in get_scripts():\n"
        "    sys.argv = ['mp', script, '--help']\n"
        "    try:\n"
        "        runpy.run_module('multiplanarunet_tpu_torch.bin.mp',\n"
        "                         run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code in (0, None), e.code\n"
        "    print('helped', script)\n"
        "print('ran')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert "--stage_dtype" in proc.stdout and "--device" in proc.stdout
    assert "--continue_training" in proc.stdout
    for flag in ("--images_per_round", "--model", "--N_channels",
                 "--CV_dir", "--validation_fraction", "--checkout",
                 "--max_loaded_images", "--extra_boxes", "--strides",
                 "--copy_weights"):
        assert flag in proc.stdout, flag
    for flag in ("--folder", "--h5", "--weights", "--tests"):
        assert flag in proc.stdout, flag
    assert proc.stdout.count("helped ") == 15
    assert proc.stdout.strip().endswith("ran")
    trimmed = nifti.load(tmp_path / "a.nii.gz").get_raw_data()
    np.testing.assert_array_equal(trimmed, vol[..., 1])


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


def test_library_entry_points_default_to_the_card(monkeypatch):
    """Trainer and get_sequence run on the card unless given a device:
    with none visible they raise, and never turn into the CPU; the CLIs'
    --device cpu and an explicit device="cpu" still work."""
    from multiplanarunet_tpu_torch.models.unet import UNet
    from multiplanarunet_tpu_torch.preprocessing.data_preparation_funcs \
        import get_sequencers
    from multiplanarunet_tpu_torch.sequences import get_sequence
    from multiplanarunet_tpu_torch.train.trainer import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = UNet(n_classes=2, n_channels=1, depth=1, init_filters=2)
    kw = dict(intrp_style="iso_live", dim=16, batch_size=2, n_classes=2,
              views=np.eye(3), real_space_span=16.0, no_log=True)
    with pytest.raises(_device.CudaUnavailableError):
        Trainer(model)
    with pytest.raises(_device.CudaUnavailableError):
        get_sequence([], **kw)
    with pytest.raises(_device.CudaUnavailableError):
        get_sequencers(["queue"], None, print,
                       {"build": {"dim": 16, "n_classes": 2},
                        "fit": dict(intrp_style="iso_live", batch_size=2,
                                    views=np.eye(3), no_log=True)})
    assert Trainer(model, device="cpu").device.type == "cpu"
    assert get_sequence([], device="cpu", **kw).device.type == "cpu"
    assert _device.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(_device.CudaUnavailableError):
        _device.resolve_device("cuda:1")


def test_build_raises_named_error_without_nvcc(tmp_path, monkeypatch):
    """No nvcc anywhere: a named error, no fallback and no library."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "empty_bin"))
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.build(build_dir=tmp_path / "kernels")
    assert not (tmp_path / "kernels").exists()
