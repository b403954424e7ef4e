"""Every public name of every subpackage `__init__` of the JAX package
exists in the port's matching `__init__`, and every public module-level
def and public class method of every JAX module exists in the port's
module of the same path, or sits in an allow-list below with the reason
the port has no such name."""
import ast
import importlib
import pkgutil
from pathlib import Path

import pytest

import multiplanarunet_tpu
from tests.torch_projects import torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
_FLAX_STATE = ("flax idiom: the state lives in the torch model and "
               "optimizer, driven by the port's TrainStep and EvalStep "
               "(train/train_step.py)")
ALLOWED = {
    "train": {name: _FLAX_STATE for name in (
        "TrainState", "create_train_state", "make_train_step",
        "make_eval_step")},
    "models": {
        "FusionLayer": "flax submodule of FusionModel; the port's "
                       "FusionModel holds its W and b itself",
    },
}


_NOT_PORTED = ("ROADMAP 'Do not port': a workaround for the remote TPU "
               "transport with no job on a local card")
MODULE_ALLOWED = {
    "ops.pallas_shear": {
        "pass_pallas": "the Pallas entry of the shear pass: the port's "
                       "kernel is CUDA C++ (csrc/shear_pass.cu) behind "
                       "ops/shear_pass.py:shear_pass",
    },
    "ops.interp": {
        "grid_gather_pool_packed": _NOT_PORTED + " (the corner-packed "
                                   "pool twin)",
        "sample_plane_batch_pool_packed": _NOT_PORTED + " (the "
                                          "corner-packed pool twin)",
    },
    "parallel.volume_pool": {
        "DeviceVolumePool.packed": _NOT_PORTED + " (the corner-packed "
                                   "pool twin)",
    },
    "train.trainer": {
        "Trainer.synced_dispatch": _NOT_PORTED + " (the gloo compile-skew "
                                   "barrier)",
    },
    "utils.compilation_cache": {
        "enable_compilation_cache": _NOT_PORTED + " (the XLA compile "
                                    "cache)",
    },
    "models.fusion_model": {
        "FusionLayer": ALLOWED["models"]["FusionLayer"],
        "FusionLayer.regularizer": "FusionModel.regularizer holds it",
    },
    "train.train_step": {
        **{name: _FLAX_STATE for name in ALLOWED["train"]},
        "TrainState.learning_rate": _FLAX_STATE,
        "TrainState.with_learning_rate": _FLAX_STATE,
        "make_multitask_train_step": _FLAX_STATE + " (MultiTaskTrainStep)",
        "make_multitask_eval_step": _FLAX_STATE + " (MultiTaskEvalStep)",
    },
}


def _public_names(init_path):
    """Names an __init__ binds at its top level: its imports and defs,
    without the private ones."""
    names = []
    for node in ast.parse(init_path.read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.module != "__future__":
            names += [a.asname or a.name for a in node.names]
        elif isinstance(node, ast.Import):
            names += [(a.asname or a.name).split(".")[0] for a in node.names]
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
    return [n for n in names if not n.startswith("_")]


def _subpackages():
    out = [""]
    prefix = "multiplanarunet_tpu."
    for info in pkgutil.walk_packages(multiplanarunet_tpu.__path__, prefix):
        if info.ispkg:
            out.append(info.name[len(prefix):])
    return out


SUBPACKAGES = _subpackages()


def test_every_jax_subpackage_is_checked():
    assert {"callbacks", "train", "models", "preprocessing", "utils",
            "utils.fusion", "sequences", "parallel", "image.queue",
            "evaluate"} <= set(SUBPACKAGES)
    assert len(SUBPACKAGES) >= 18


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_port_exports_the_jax_public_names(sub):
    jax_init = (REPO / "multiplanarunet_tpu" / sub.replace(".", "/")
                / "__init__.py")
    port = importlib.import_module(
        "multiplanarunet_tpu_torch" + (f".{sub}" if sub else ""))
    allowed = ALLOWED.get(sub, {})
    names = _public_names(jax_init)
    missing = [n for n in names if not hasattr(port, n) and n not in allowed]
    assert not missing, f"{sub or 'package'}: {missing}"
    # the allow-list holds JAX names only, and none the port has
    assert set(allowed) <= set(names)
    assert not [n for n in allowed if hasattr(port, n)]
    assert all(reason.strip() for reason in allowed.values())


def test_root_version_matches():
    import multiplanarunet_tpu_torch

    assert multiplanarunet_tpu_torch.__version__ == \
        multiplanarunet_tpu.__version__


def _module_names(path):
    """Public module-level defs and classes of a module, and each public
    class's public methods and properties as 'Class.name'."""
    names = []
    for node in ast.parse(path.read_text()).body:
        if not isinstance(node, (ast.FunctionDef, ast.ClassDef)) or \
                node.name.startswith("_"):
            continue
        names.append(node.name)
        if isinstance(node, ast.ClassDef):
            names += [f"{node.name}.{b.name}" for b in node.body
                      if isinstance(b, ast.FunctionDef)
                      and not b.name.startswith("_")]
    return list(dict.fromkeys(names))


def _modules():
    root = REPO / "multiplanarunet_tpu"
    return sorted(".".join(p.relative_to(root).with_suffix("").parts)
                  for p in root.rglob("*.py") if p.name != "__init__.py")


MODULES = _modules()


def _has(obj, dotted):
    for part in dotted.split("."):
        if not hasattr(obj, part):
            return False
        obj = getattr(obj, part)
    return True


def test_every_jax_module_is_checked():
    assert {"sequences.multi_planar", "utils.fusion.fuse_and_predict",
            "image.volume_sampler", "ops.geometry", "ops.interp",
            "ops.shear", "sequences.utils", "bin.train"} <= set(MODULES)
    assert len(MODULES) >= 60
    assert set(MODULE_ALLOWED) <= set(MODULES)


@pytest.mark.parametrize("mod", MODULES)
def test_port_module_has_the_jax_defs_and_methods(mod):
    """The port's module of the same path holds each public def, class
    and class method of the JAX module, or the name is allow-listed with
    a reason (a JAX module with no port module has every name
    allow-listed)."""
    names = _module_names(REPO / "multiplanarunet_tpu" /
                          (mod.replace(".", "/") + ".py"))
    allowed = MODULE_ALLOWED.get(mod, {})
    try:
        port = importlib.import_module(f"multiplanarunet_tpu_torch.{mod}")
    except ModuleNotFoundError:
        port = None
    missing = [n for n in names
               if n not in allowed and (port is None or not _has(port, n))]
    assert not missing, f"{mod}: {missing}"
    assert set(allowed) <= set(names)
    if port is not None:
        assert not [n for n in allowed if _has(port, n)]
    assert all(reason.strip() for reason in allowed.values())

