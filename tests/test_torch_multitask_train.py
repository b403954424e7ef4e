"""Multi-task training on the PyTorch port, on the CPU: the port's
`prepare_for_multi_task_2d` against the JAX package's on the same two toy
tasks (the Auditor's task_specifics, the build lists, views_<task>.npz and
the per-task batches from one numpy seed); the port's `mp init_project
--model MultiTask` -> `mp train` -> `mp train --continue_training` -> `mp
branch` in a subprocess where jax, flax, optax, yaml and the JAX package
cannot be imported, mirroring tests/test_multitask.py; and the repairs
that per-task batch lists needed in `prefetched` and
`Trainer._stop_queues`."""
import contextlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from multiplanarunet_tpu.bin import init_project as j_init_project
from multiplanarunet_tpu.hyperparameters import YAMLHParams as JHParams
from multiplanarunet_tpu.logging import ScreenLogger as JScreen
from multiplanarunet_tpu.models import checkpoint as jckpt
from multiplanarunet_tpu.preprocessing import data_preparation_funcs as jprep
from multiplanarunet_tpu_torch.bin import mp as t_mp
from multiplanarunet_tpu_torch.hyperparameters.hparams import YAMLHParams
from multiplanarunet_tpu_torch.hyperparameters.yaml_reader import safe_load
from multiplanarunet_tpu_torch.logging.loggers import ScreenLogger
from multiplanarunet_tpu_torch.preprocessing import (
    data_preparation_funcs as tprep,
)
from multiplanarunet_tpu_torch.sequences import base_sequence
from multiplanarunet_tpu_torch.sequences.multi_task import MultiTaskSequence
from multiplanarunet_tpu_torch.train.trainer import Trainer
from tests.torch_projects import edit_yaml, torch_threads  # noqa: F401


REPO = Path(__file__).resolve().parents[1]
BANNED = ("jax", "flax", "optax", "yaml", "multiplanarunet_tpu")
# The shrink of tests/test_multitask.py, and a batch of 4
SHRINK = (("complexity_factor: 2", "complexity_factor: 0.02"),
          ("depth: 4", "depth: 2"), ("views: 6", "views: 1"),
          ("mixed_precision: True", "mixed_precision: False"),
          ("batch_size: 16", "batch_size: 4"))
ELASTIC = ('  augmenters: [\n    {cls_name: "Elastic2D",\n     kwargs: '
           '{alpha: [0, 450], sigma: [20, 30], apply_prob: 0.333}}\n  ]')
TRAIN_ARGS = ["--device", "cpu", "--no_images",
              "--train_images_per_epoch", "8", "--val_images_per_epoch", "4"]

CHAIN = f"""
import os, shutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in {BANNED!r}:
            raise ImportError(f'blocked: {{name}}')
sys.meta_path.insert(0, Block())
from pathlib import Path
from multiplanarunet_tpu_torch.bin import mp
import torch
torch.set_num_threads(2)
ws = Path(sys.argv[1])
def run(*args):
    cwd = os.getcwd()
    try:
        mp.entry_func(list(args))
    finally:
        os.chdir(cwd)
for name, size, seed in (("data1", 32, 10), ("data2", 48, 20)):
    run("toy_data", "--out_dir", str(ws / name), "--N_train", "2",
        "--N_val", "1", "--N_test", "1", "--image_size", str(size),
        "--seed", str(seed))
run("init_project", "--name", "proj", "--root", str(ws), "--model",
    "MultiTask", "--data_dir", str(ws / "data1"))
proj = ws / "proj"
hp = proj / "train_hparams.yaml"
text = hp.read_text()
for old, new in {SHRINK!r}:
    text = text.replace(old, new)
hp.write_text(text)
t2 = proj / "task_2.yaml"
t2.write_text(t2.read_text().replace(str(ws / "data1"), str(ws / "data2")))
run("train", "--project_dir", str(proj), "--overwrite", "--epochs", "2",
    *{TRAIN_ARGS!r})
shutil.copy(proj / "logs" / "training.csv", ws / "training_2_epochs.csv")
run("train", "--project_dir", str(proj), "--continue_training", "--epochs",
    "3", *{TRAIN_ARGS!r})
run("branch", "--project_dir", str(proj), "--copy_weights")
bad = sorted(m for m in sys.modules if m.split('.')[0] in {BANNED!r})
assert not bad, bad
print("chain ok")
"""


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The port's whole multi-task chain, run once with the JAX side
    blocked; returns the workspace."""
    ws = tmp_path_factory.mktemp("mt_chain")
    proc = subprocess.run([sys.executable, "-c", CHAIN, str(ws)], cwd=REPO,
                          capture_output=True, text=True, timeout=90)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("chain ok")
    return ws


def test_mp_train_multitask_runs(chain):
    """As tests/test_multitask.py::test_multitask_training_runs, and the
    per-task validation logs."""
    proj = chain / "proj"
    for i in (1, 2):
        spec = yaml.safe_load(
            (proj / f"task_{i}.yaml").read_text())["task_specifics"]
        assert spec["n_classes"] == 4
        assert spec["n_channels"] == 1
        assert spec["dim"] is not None
    hp = yaml.safe_load((proj / "train_hparams.yaml").read_text())
    assert hp["build"]["task_names"] == ["task_1", "task_2"]
    assert hp["build"]["n_classes"] == [4, 4]
    assert len(hp["build"]["dim"]) == 2
    assert hp["tasks"]["task_names"] == ["task_1", "task_2"]
    for name in ("task_1", "task_2"):
        v = np.load(proj / f"views_{name}.npz")["arr_0"]
        assert v.shape == (1, 3)
    assert (proj / "model" / "model_weights.npz").exists()
    csv = (chain / "training_2_epochs.csv").read_text()
    header = csv.splitlines()[0].split(",")
    for key in ("val_dice", "task_0/loss", "task_1/loss", "val_task_0/dice",
                "val_task_1/dice", "val_task_1/loss"):
        assert key in header, key
    assert len(csv.strip().splitlines()) == 3  # header + 2 epochs


def test_multitask_shared_encoder_params(chain):
    """One encoder, shared across tasks, and a head per task, read by the
    JAX package's checkpoint loader."""
    params, stats, _ = jckpt.load_weights(
        chain / "proj" / "model" / "model_weights.npz")
    assert set(params) == {"encoder", "task_task_1", "task_task_2"}
    assert set(stats) == set(params)
    assert set(params["encoder"]) == {"encoder_L0", "encoder_L1"}
    assert params["task_task_2"]["out_conv"]["kernel"].shape[-1] == 4


def test_multitask_continue_training(chain):
    lines = (chain / "proj" / "logs" / "training.csv").read_text().strip()
    lines = lines.splitlines()
    assert len(lines) == 4  # one more epoch
    assert [r.split(",")[0] for r in lines[1:]] == ["0", "1", "2"]


def test_branch_of_the_trained_project(chain):
    """Per task a UNet project with its task's n_classes and dim, read
    back by the port's reader; model/ copied; no views copied (the JAX
    script copies views.npz, which multi-task training does not write)."""
    proj = chain / "proj"
    build = safe_load((proj / "train_hparams.yaml").read_text())["build"]
    for t, task in enumerate(("task_1", "task_2")):
        branch = proj / "branches" / task
        hp = safe_load((branch / "train_hparams.yaml").read_text())
        assert hp["build"]["model_class_name"] == "UNet"
        assert hp["build"]["n_classes"] == 4
        assert hp["build"]["dim"] == build["dim"][t]
        assert hp["train_data"]["base_dir"].endswith(f"data{t + 1}/train")
        assert (branch / "model" / "model_weights.npz").exists()
        assert not (branch / "views.npz").exists()


def _projects(root, data):
    """The same MultiTask project made by each package's init_project,
    shrunk, without Elastic2D (its warp is held against the JAX package
    in tests/test_torch_pooled_sampler.py)."""
    projects = {}
    for name, init in (("jax", j_init_project.entry_func),
                       ("port", lambda a: t_mp.entry_func(
                           ["init_project", *a]))):
        init(["--name", name, "--root", str(root), "--model", "MultiTask",
              "--data_dir", str(data / "data1")])
        proj = root / name
        edit_yaml(proj / "train_hparams.yaml",
                  SHRINK + ((ELASTIC, "  augmenters: []"),
                            ("views: 1", "views: 2")))
        t2 = proj / "task_2.yaml"
        t2.write_text(t2.read_text().replace(str(data / "data1"),
                                             str(data / "data2")))
        projects[name] = proj
    return projects


def test_prepare_for_multi_task_2d_matches_jax(chain, tmp_path):
    """The same task_specifics, build lists and views files, and from one
    numpy seed the same per-task batches (images within 1e-5 of the
    batch's largest intensity, labels equal on >= 0.9999 of pixels,
    weights equal). The JAX pooled sampler draws a batch ahead of the one
    it returns (its transport lookahead, not ported), so its first two
    multi-task batches draw task 1's batches 0-1, then task 2's 0-1; the
    port's per-task sequences are drawn in that order."""
    projects = _projects(tmp_path, chain)
    seqs = {}
    for name, hp_cls, prep, log in (
            ("jax", JHParams, jprep.prepare_for_multi_task_2d,
             JScreen(False)),
            ("port", YAMLHParams, tprep.prepare_for_multi_task_2d,
             ScreenLogger(False))):
        hparams = hp_cls(projects[name] / "train_hparams.yaml", logger=log)
        kw = {"device": "cpu"} if name == "port" else {}
        np.random.seed(5)
        cwd = os.getcwd()
        try:
            seqs[name] = prep(hparams, logger=log,
                              base_path=str(projects[name]), **kw)
        finally:
            os.chdir(cwd)
    for i in (1, 2):
        specs = [yaml.safe_load((projects[n] / f"task_{i}.yaml").read_text())
                 ["task_specifics"] for n in ("jax", "port")]
        assert specs[0] == specs[1]
        views = [np.load(projects[n] / f"views_task_{i}.npz")["arr_0"]
                 for n in ("jax", "port")]
        assert views[0].shape == (2, 3)
        np.testing.assert_array_equal(views[0], views[1])
    builds = [yaml.safe_load((projects[n] / "train_hparams.yaml").read_text())
              ["build"] for n in ("jax", "port")]
    for key in ("task_names", "n_classes", "n_channels", "dim"):
        assert builds[0][key] == builds[1][key], key
    for name, (train, val) in seqs.items():
        assert type(train).__name__ == type(val).__name__ == \
            "MultiTaskSequence"
        for seq in train.sequences:
            seq.seed = lambda: None  # the test seeds numpy itself
    np.random.seed(21)
    want = [seqs["jax"][0][i] for i in range(2)]
    np.random.seed(21)
    per_task = [[seq[i] for i in range(2)] for seq in seqs["port"][0].sequences]
    got = [[list(part) for part in zip(*(task[i] for task in per_task))]
           for i in range(2)]
    for (jxs, jys, jws), (txs, tys, tws) in zip(want, got):
        assert len(txs) == len(jxs) == 2
        for jx, jy, jw, tx, ty, tw in zip(jxs, jys, jws, txs, tys, tws):
            jx, jy = np.asarray(jx), np.asarray(jy)
            assert tx.shape == jx.shape and tx.shape[0] == 4
            err = np.abs(tx.numpy() - jx).max()
            assert err <= 1e-5 * np.abs(jx).max(), err
            assert (ty.numpy() == jy).mean() >= 0.9999
            np.testing.assert_array_equal(tw, jw)


class _Staged:
    """A batch tensor that records the streams it is marked used on."""

    def __init__(self):
        self.streams = []

    def record_stream(self, stream):
        self.streams.append(stream)


def test_prefetched_records_every_task_tensor(monkeypatch):
    """On a card, prefetched marks every tensor of a multi-task batch (its
    per-task lists) as used on the caller's stream; the card's streams
    and events are stood in for here."""
    class Stream:
        def wait_event(self, event):
            pass

    class Event:
        def record(self, stream=None):
            pass

    caller = Stream()
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: caller)
    batches = [([_Staged(), _Staged()], [_Staged(), _Staged()], [0, 0])
               for _ in range(2)]

    class Seq:
        def __getitem__(self, i):
            return batches[i]

    got = list(base_sequence.prefetched(Seq(), 2, "cuda"))
    assert got == batches
    for xs, ys, _ in batches:
        for t in xs + ys:
            assert t.streams == [caller]


def test_stop_queues_deregisters_every_task():
    """Trainer._stop_queues de-registers each task's LimitationQueue from
    its loading pool, the second task's too (a MultiTaskSequence's
    image_pair_queue is only its first task's)."""
    released = []

    class Pool:
        def de_register_dataset(self, identifier):
            released.append(identifier)

    def task_seq(name):
        queue = type("Q", (), {})()
        queue.loading_pool = Pool()
        queue.dataset = type("D", (), {"identifier": name})()
        seq = type("S", (), {})()
        seq.image_pair_queue = queue
        return seq

    train = MultiTaskSequence([task_seq("t1"), task_seq("t2")], ["1", "2"],
                              no_log=True)
    val = MultiTaskSequence([task_seq("v1"), task_seq("v2")], ["1", "2"],
                            no_log=True)
    Trainer._stop_queues(train, val)
    assert released == ["t1", "t2", "v1", "v2"]
    released.clear()
    Trainer._stop_queues(task_seq("single"), None)
    assert released == ["single"]
