"""Every public name of every subpackage `__init__` of the JAX package
exists in the port's matching `__init__`, or sits in the allow-list below
with the reason the port has no such name."""
import ast
import importlib
import pkgutil
from pathlib import Path

import pytest

import multiplanarunet_tpu

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
        "init_model_variables": "flax init of a variable tree; a torch "
                                "model owns its parameters (glorot_init "
                                "in models/unet.py)",
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
