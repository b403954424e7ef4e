"""`mp branch` on the PyTorch port against the JAX package's: the JAX
test's project (tests/test_cli_tools.py::test_branch_multitask_project),
the merged single-task dict per task equal to the JAX `build_branch_yaml`
on the same files, --copy_weights; and the port's YAML writer read back by
PyYAML and by the port's reader on the presets' values and on generated
strings, numbers and nestings."""
import math
import shutil
from pathlib import Path

import numpy as np
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from multiplanarunet_tpu.bin import branch as j_branch
from multiplanarunet_tpu_torch.bin import branch as t_branch
from multiplanarunet_tpu_torch.bin import mp as t_mp
from multiplanarunet_tpu_torch.bin.init_project import defaults_dir
from multiplanarunet_tpu_torch.hyperparameters.yaml_reader import safe_load
from multiplanarunet_tpu_torch.hyperparameters.yaml_writer import safe_dump
from tests.torch_projects import torch_threads  # noqa: F401


def _project(tmp_path, filled=False):
    """The MultiTask preset's files; with filled, the values training
    writes (the Auditor's task_specifics, the build lists)."""
    proj = tmp_path / "mt"
    proj.mkdir(parents=True)
    for f in (defaults_dir() / "MultiTask").glob("*.yaml"):
        shutil.copy(f, proj / f.name)
    if filled:
        for i, (nc, dim, span) in enumerate(((7, 256, 255.0),
                                             (4, 192, 191.5)), 1):
            path = proj / f"task_{i}.yaml"
            text = path.read_text()
            for old, new in (("n_classes: Null", f"n_classes: {nc}"),
                             ("n_channels: Null", "n_channels: 1"),
                             ("dim: Null", f"dim: {dim}"),
                             ("real_space_span: Null",
                              f"real_space_span: {span}"),
                             ("base_dir: Null", f"base_dir: /data/t{i}")):
                text = text.replace(old, new)
            path.write_text(text)
        main = proj / "train_hparams.yaml"
        main.write_text(main.read_text().replace(
            "  depth: 4\n", "  depth: 4\n  task_names: ['task_1', 'task_2']\n"
            "  n_classes: [7, 4]\n  n_channels: [1, 1]\n  dim: [256, 192]\n"))
    return proj


def _same(a, b):
    """Equal values of equal types, recursively (True == 1 does not
    count; NaN equals NaN)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def test_branch_multitask_project(tmp_path):
    """As the JAX test: a branch folder per task with its YAML (a UNet,
    PyYAML reads it) and the project's views.npz."""
    proj = _project(tmp_path)
    np.savez(proj / "views", np.eye(3))
    t_mp.entry_func(["branch", "--project_dir", str(proj)])
    for task in ("task_1", "task_2"):
        bdir = proj / "branches" / task
        assert (bdir / "train_hparams.yaml").exists()
        assert (bdir / "views.npz").exists()
        hp = yaml.safe_load((bdir / "train_hparams.yaml").read_text())
        assert hp["build"]["model_class_name"] == "UNet"
        assert "train_data" in hp and "fit" in hp
        assert not (bdir / "model").exists()


def test_merged_dicts_equal_jax_build_branch_yaml(tmp_path):
    """On the preset and on a trained project's values: the port's merged
    dict (from its reader) equals the JAX build_branch_yaml's (from
    PyYAML), and the file the port writes reads back to it with both
    readers; --copy_weights copies model/."""
    for filled in (False, True):
        proj = _project(tmp_path / str(filled), filled)
        (proj / "model").mkdir()
        (proj / "model" / "model_weights.npz").write_bytes(b"w")
        t_branch.entry_func(["--project_dir", str(proj), "--out_dir", "b",
                             "--copy_weights"])
        main_text = (proj / "train_hparams.yaml").read_text()
        for task in ("task_1", "task_2"):
            task_text = (proj / f"{task}.yaml").read_text()
            want = j_branch.build_branch_yaml(yaml.safe_load(main_text),
                                              yaml.safe_load(task_text))
            got = t_branch.build_branch_yaml(safe_load(main_text),
                                             safe_load(task_text))
            assert _same(got, want)
            written = (proj / "b" / task / "train_hparams.yaml").read_text()
            assert _same(yaml.safe_load(written), want)
            assert _same(safe_load(written), want)
            assert (proj / "b" / task / "model" / "model_weights.npz"
                    ).read_bytes() == b"w"
            if filled:
                assert want["build"]["n_classes"] == (7 if task == "task_1"
                                                      else 4)
                assert want["build"]["model_class_name"] == "UNet"


def test_writer_round_trips_the_presets():
    """Every preset of the port, as loaded: the writer's text reads back
    to the same value with PyYAML and with the port's reader, including
    the checkpoint path template, '1pct' and the learning rate 5e-05."""
    texts = [p.read_text() for p in Path(defaults_dir()).glob("*/*.yaml")]
    assert len(texts) == 5
    for text in texts:
        value = yaml.safe_load(text)
        out = safe_dump(value)
        assert _same(yaml.safe_load(out), value)
        assert _same(safe_load(out), value)
    out = safe_dump({"filepath": "./model/@epoch_{epoch:02d}.npz",
                     "bg_value": "1pct", "lr": 5e-05, "none": None})
    assert 'filepath: "./model/@epoch_{epoch:02d}.npz"' in out
    assert "lr: 5.0e-05" in out and "none: Null" in out


SCALARS = (st.none() | st.booleans() | st.integers()
           | st.floats(allow_nan=True) | st.text()
           | st.sampled_from(["Null", "yes", "off", "1e-5", "0x1F", "1:30",
                              "2001-12-14", ".5", "~", "-", "? a", "a: b",
                              "#c", "&x", "*x", "- a", "[1]", "{a: 1}",
                              "'q'", '"q"', " pad ", "tab\tand\nnewline",
                              "é \U0001f600", "=", "<<"]))
VALUES = st.recursive(
    SCALARS, lambda inner: st.lists(inner, max_size=4)
    | st.dictionaries(st.text(max_size=8), inner, max_size=4), max_leaves=12)


@settings(max_examples=300, deadline=None, derandomize=True, database=None)
@given(VALUES)
def test_writer_round_trips_generated_values(value):
    out = safe_dump(value)
    assert out.isascii()
    assert _same(yaml.safe_load(out), value), out
    assert _same(safe_load(out), value), out
