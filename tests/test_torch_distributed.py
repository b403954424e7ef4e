"""The port's multi-process layer (`multiplanarunet_tpu_torch.parallel`)
executed for real: two OS processes join one gloo group on the CPU under
the MPUNET_* launch markers (the path `mp train` takes) and train the tiny
2D U-Net of `tests/test_distributed.py` (dim 16, depth 1, 4 filters, 3
classes) with DistributedDataParallel and global-batch BatchNorm, plus one
3D and one multi-task step. The JAX package's Trainer over a 2-device mesh
of this process's virtual CPU devices runs the same global batches from the
same weights (carried by the checkpoint format), and the workers' results
are held against it: the mesh spans the processes, the loss falls and the
replicas stay bit-identical, the parameters after 3 Adam steps, the
multi-process Validation (with and without a padded global batch) against
the single-process one, task_group_mesh, and the global BatchNorm forward
and backward against a float64 oracle on the concatenated batch. Then an
explicit 2-process start-up that fails must raise, and `mp train
--num_devices 2 --device cpu` pads a global batch of 3 to 4 as the JAX
package's 2-device mesh does."""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multiplanarunet_tpu.callbacks.validation import (
    Validation as JValidation,
)
from multiplanarunet_tpu.logging import ScreenLogger as JScreen
from multiplanarunet_tpu.models import UNet as JUNet
from multiplanarunet_tpu.models import checkpoint as jckpt
from multiplanarunet_tpu.models.multitask_unet import (
    MultiTaskUNet2D as JMultiTask,
)
from multiplanarunet_tpu.models.unet3d import UNet3D as JUNet3D
from multiplanarunet_tpu.parallel import get_mesh as j_get_mesh
from multiplanarunet_tpu.parallel import (
    pad_batch_to_multiple as j_pad_batch_to_multiple,
)
from multiplanarunet_tpu.train import Trainer as JTrainer
from multiplanarunet_tpu_torch.models.unet import _BatchStatsNorm
from multiplanarunet_tpu_torch.parallel import pad_batch_to_multiple
from tests.torch_projects import (  # noqa: F401
    edit_yaml,
    flax_init,
    toy_data,
    torch_threads,
)


REPO = Path(__file__).resolve().parents[1]
LR = 1e-2
GLOBAL_BATCH, N_STEPS = 8, 3
MT_DIMS = (16, 12)
BN_SHAPE = (8, 3, 6, 5)
# A worker group's deadline, about 3x the longest wait measured under the
# full suite (18.8 s): a hang fails its test, not the suite
TIMEOUT = 60

WORKER = r"""
import json, os, sys
import numpy as np
import torch

torch.set_num_threads(1)
out = sys.argv[1]
data = dict(np.load(os.path.join(out, "data.npz")))

from multiplanarunet_tpu_torch.callbacks.validation import Validation
from multiplanarunet_tpu_torch.logging.loggers import ScreenLogger
from multiplanarunet_tpu_torch.models import checkpoint
from multiplanarunet_tpu_torch.models.model_init import load_unet_weights
from multiplanarunet_tpu_torch.models.multitask_unet import MultiTaskUNet2D
from multiplanarunet_tpu_torch.models.unet import UNet, _BatchStatsNorm
from multiplanarunet_tpu_torch.models.unet3d import UNet3D
from multiplanarunet_tpu_torch.parallel import (
    broadcast_from_main, get_mesh, is_main_process, local_batch_slice,
    maybe_initialize_distributed, process_barrier, replicate, shard_batch,
    task_group_mesh,
)

cpu = torch.device("cpu")
n, pid = maybe_initialize_distributed(device=cpu)
mesh = get_mesh()
groups = task_group_mesh(2)
whole = task_group_mesh(1)
res = {"n": n, "pid": pid, "mesh": mesh.mesh.tolist(),
       "mesh_names": list(mesh.mesh_dim_names),
       "groups": [groups[0].mesh.tolist(), groups[1]],
       "whole": [whole[0].mesh.tolist(), whole[1]],
       "main": is_main_process(),
       "bcast": broadcast_from_main(np.array([10 + pid])).tolist()}
process_barrier("worker-start")
arrays = {}


def trainer_for(model, path):
    from multiplanarunet_tpu_torch.train.trainer import Trainer

    tr = Trainer(load_unet_weights(model, os.path.join(out, path)),
                 logger=ScreenLogger(False), device=cpu)
    return tr.compile_model("Adam", {"lr": float(data["lr"])},
                            loss="SparseCategoricalCrossentropy", metrics=[])


def flat_params(model, prefix):
    params, stats = checkpoint.unet_variables_from_model(model)
    for name, tree in (("params", params), ("stats", stats)):
        stack = [(name, tree)]
        while stack:
            key, node = stack.pop()
            for k, v in node.items():
                if isinstance(v, dict):
                    stack.append((f"{key}/{k}", v))
                else:
                    arrays[f"{prefix}:{key}/{k}"] = np.asarray(v)


# --- 2D: 3 Adam steps over the global batches, each rank its half
start, local = local_batch_slice(int(data["x2d"].shape[1]))
tr = trainer_for(UNet(3, 1, depth=1, init_filters=4), "w2d.npz")
losses = []
for s in range(data["x2d"].shape[0]):
    x, y, w = shard_batch((data["x2d"][s, start:start + local],
                           data["y2d"][s, start:start + local],
                           data["w2d"][s, start:start + local]), mesh, cpu)
    losses.append(float(tr.train_step(x, y, w)["loss"]))
res["losses"] = losses
res["checksum"] = float(sum(p.double().abs().sum()
                            for p in tr.model.parameters()))
flat_params(tr.model, "2d")

# --- one 3D step and one multi-task step
start3, local3 = local_batch_slice(int(data["x3d"].shape[0]))
tr3 = trainer_for(UNet3D(3, 1, depth=1, init_filters=4), "w3d.npz")
sl = slice(start3, start3 + local3)
res["loss3d"] = float(tr3.train_step(
    *shard_batch((data["x3d"][sl], data["y3d"][sl], data["w3d"][sl]),
                 device=cpu)
)["loss"])
flat_params(tr3.model, "3d")
trm = trainer_for(MultiTaskUNet2D(("a", "b"), (3, 4), (1, 1), depth=1,
                                  init_filters=4), "wmt.npz")
xs, ys, ws = ([torch.from_numpy(data[f"{k}mt{t}"][sl]) for t in (0, 1)]
              for k in "xyw")
logs = trm.train_step(xs, ys, ws)
res["lossmt"] = {k: float(v) for k, v in logs.items()}
flat_params(trm.model, "mt")

# --- Validation over the global batch: local 3 rows each (global 6), and
# a global 5 padded to 6 (rank 1: 2 valid rows and 1 pad row)
for name, n_global in (("val", 6), ("val_pad", 5)):
    vt = trainer_for(UNet(3, 1, depth=1, init_filters=4), "w2d.npz")
    vt.pad_global_batch = True
    vt._share = vt._batch_share(n_global)
    _, padded, local_v, valid = vt._share
    rows = slice(pid * local_v, pid * local_v + valid)
    part = tuple(torch.from_numpy(data[f"{k}val"][:n_global][rows])
                 for k in "xyw")

    class Replay:
        batch_size = valid

        def __getitem__(self, i):
            return part

    cb = Validation(Replay(), steps=2, logger=ScreenLogger(False),
                    verbose=False)
    cb.set_trainer(vt)
    val_logs = {}
    cb.on_epoch_end(0, val_logs)
    res[name] = {"val_loss": val_logs["val_loss"],
                 "val_dice": val_logs["val_dice"], "padded": padded,
                 "valid": valid}

# --- global BatchNorm: each rank its half, loss = sum(y * r) over its rows
half = data["bn_x"].shape[0] // n
rows = slice(pid * half, (pid + 1) * half)
x = torch.from_numpy(data["bn_x"][rows]).requires_grad_()
weight = torch.from_numpy(data["bn_w"]).requires_grad_()
bias = torch.from_numpy(data["bn_b"]).requires_grad_()
y, mean, var = _BatchStatsNorm.apply(x, weight, bias, 1e-3, True)
(y * torch.from_numpy(data["bn_r"][rows])).sum().backward()
for k, v in (("y", y), ("dx", x.grad), ("dw", weight.grad),
             ("db", bias.grad), ("mean", mean), ("var", var)):
    arrays[f"bn:{k}"] = v.detach().numpy()

# --- replicate: rank-dependent values become rank 0's
model = UNet(3, 1, depth=1, init_filters=4)
with torch.no_grad():
    for p in model.parameters():
        p.fill_(float(pid + 1))
replicate(model)
res["replicated"] = sorted({float(p.flatten()[0])
                            for p in model.parameters()})

np.savez(os.path.join(out, f"rank{pid}.npz"), **arrays)
process_barrier("worker-end")
print("RESULT " + json.dumps(res))
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(extra=None):
    """The environment of a worker process: the repository importable, one
    intra-op thread (several workers share the test machine's cores)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH", "")) if p)
    env["OMP_NUM_THREADS"] = "1"
    env.update(extra or {})
    return env


def launch(script, args, n_procs, cwd, timeout=TIMEOUT):
    """Run `script args` as n_procs ranks under the MPUNET_* markers;
    returns each rank's stdout. A hang or a failure fails the test."""
    addr = f"localhost:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, str(script), *args], cwd=cwd, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=_env({"MPUNET_COORDINATOR_ADDRESS": addr,
                  "MPUNET_NUM_PROCESSES": str(n_procs),
                  "MPUNET_PROCESS_ID": str(pid)}))
        for pid in range(n_procs)]
    outs, errs = [], []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"{script.name} worker timed out")
        outs.append(out)
        errs.append(err)
    failed = [r for r, p in enumerate(procs) if p.returncode]
    assert not failed, "\n".join(f"rank {r} failed:\n{errs[r][-3000:]}"
                                  for r in failed)
    return outs


def _weights(path, jmodel, shape):
    """Random flax variables of jmodel (PRNGKey(0)) on zero inputs of
    `shape`, written as a JAX-format checkpoint; returns them."""
    variables = flax_init(jmodel, jax.random.PRNGKey(0), shape)
    variables = jax.tree.map(np.asarray, dict(variables))
    jckpt.save_weights(path, variables["params"], variables["batch_stats"])
    return variables


def _labels(x, n_classes=3):
    y = (x[..., 0] > 0.5).astype(np.int32) + (x[..., 0] > 0.8)
    return np.minimum(y, n_classes - 1)[..., None].astype(np.int32)


def _flat(tree, prefix):
    return {f"{prefix}/" + "/".join(str(p.key) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_trainer(jmodel, variables, n_devices):
    jtr = JTrainer(jmodel, variables, logger=JScreen(False),
                   mesh=j_get_mesh(jax.devices()[:n_devices]))
    return jtr.compile_model(optimizer="Adam", optimizer_kwargs={"lr": LR},
                             loss="SparseCategoricalCrossentropy",
                             metrics=[])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The workers' results next to the JAX package's on the same data."""
    out = tmp_path_factory.mktemp("torch_dist")
    rng = np.random.RandomState(100)
    data = {"lr": np.float32(LR)}
    data["x2d"] = rng.rand(N_STEPS, GLOBAL_BATCH, 16, 16, 1).astype(
        np.float32)
    data["y2d"] = _labels(data["x2d"])
    data["w2d"] = np.ones((N_STEPS, GLOBAL_BATCH), np.float32)
    data["x3d"] = rng.rand(4, 8, 8, 8, 1).astype(np.float32)
    data["y3d"] = _labels(data["x3d"])
    data["w3d"] = (rng.rand(4) + 0.5).astype(np.float32)
    for t, (d, nc) in enumerate(zip(MT_DIMS, (3, 4))):
        data[f"xmt{t}"] = rng.rand(4, d, d, 1).astype(np.float32)
        data[f"ymt{t}"] = _labels(data[f"xmt{t}"], nc)
        data[f"wmt{t}"] = np.ones(4, np.float32)
    rngv = np.random.RandomState(7)
    data["xval"] = rngv.rand(6, 16, 16, 1).astype(np.float32)
    data["yval"] = _labels(data["xval"])
    data["wval"] = np.ones(6, np.float32)
    data["bn_x"] = (2.0 * rng.randn(*BN_SHAPE) + 0.5).astype(np.float32)
    data["bn_r"] = rng.randn(*BN_SHAPE).astype(np.float32)
    data["bn_w"] = (1.0 + 0.1 * rng.randn(BN_SHAPE[1])).astype(np.float32)
    data["bn_b"] = (0.1 * rng.randn(BN_SHAPE[1])).astype(np.float32)
    np.savez(out / "data.npz", **data)

    j2d = JUNet(n_classes=3, dim=16, n_channels=1, depth=1, init_filters=4)
    v2d = _weights(out / "w2d.npz", j2d, (1, 16, 16, 1))
    j3d = JUNet3D(n_classes=3, dim=8, n_channels=1, depth=1, init_filters=4)
    v3d = _weights(out / "w3d.npz", j3d, (1, 8, 8, 8, 1))
    jmt = JMultiTask(task_names=("a", "b"), n_classes=(3, 4),
                     n_channels=(1, 1), dim=MT_DIMS, depth=1, init_filters=4)
    vmt = _weights(out / "wmt.npz", jmt,
                   tuple((1, d, d, 1) for d in MT_DIMS))

    script = out / "worker.py"
    script.write_text(WORKER)
    outs = launch(script, [str(out)], 2, out)
    results = {}
    for text in outs:
        line = [ln for ln in text.splitlines() if ln.startswith("RESULT ")]
        r = json.loads(line[-1][len("RESULT "):])
        r["arrays"] = dict(np.load(out / f"rank{r['pid']}.npz"))
        results[r["pid"]] = r

    # The JAX package's Trainer over a 2-device mesh on the global batches
    want = {}
    jtr = _jax_trainer(j2d, v2d, 2)
    jlosses = []
    for s in range(N_STEPS):
        batch = jtr._shard(jnp.asarray(data["x2d"][s]),
                           jnp.asarray(data["y2d"][s]), data["w2d"][s])
        jtr.state, logs = jtr.train_step(jtr.state, *batch)
        jlosses.append(float(logs["loss"]))
    want["losses"] = jlosses
    want["2d"] = (_flat(jtr.state.params, "params"),
                  _flat(jtr.state.batch_stats, "stats"))
    jtr3 = _jax_trainer(j3d, v3d, 2)
    jtr3.state, logs = jtr3.train_step(jtr3.state, *jtr3._shard(
        jnp.asarray(data["x3d"]), jnp.asarray(data["y3d"]), data["w3d"]))
    want["loss3d"] = float(logs["loss"])
    want["3d"] = (_flat(jtr3.state.params, "params"),
                  _flat(jtr3.state.batch_stats, "stats"))
    jtrm = _jax_trainer(jmt, vmt, 2)
    xs, ys, ws = ([jnp.asarray(data[f"{k}mt{t}"]) if k != "w"
                   else data[f"{k}mt{t}"] for t in (0, 1)] for k in "xyw")
    jtrm.state, logs = jtrm.train_step(jtrm.state, *jtrm._shard(xs, ys, ws))
    want["lossmt"] = {k: float(v) for k, v in logs.items()}
    want["mt"] = (_flat(jtrm.state.params, "params"),
                  _flat(jtrm.state.batch_stats, "stats"))
    # Single-process Validation over the same global batches
    for name, n_global in (("val", 6), ("val_pad", 5)):
        vtr = _jax_trainer(j2d, v2d, 1)
        part = (data["xval"][:n_global], data["yval"][:n_global],
                data["wval"][:n_global])

        class Replay:
            batch_size = n_global

            def __getitem__(self, i):
                return part

        cb = JValidation(Replay(), steps=2, logger=JScreen(False),
                         verbose=False)
        cb.set_trainer(vtr)
        logs = {}
        cb.on_epoch_end(0, logs)
        want[name] = logs
    return results, want, data


def test_mesh_spans_the_processes(run):
    """get_mesh is a 1-D 'data' mesh over both ranks; rank 0 is the main
    process, its broadcast reaches both."""
    results, _, _ = run
    for pid, r in results.items():
        assert (r["n"], r["pid"]) == (2, pid)
        assert r["mesh"] == [0, 1] and r["mesh_names"] == ["data"]
        assert r["main"] == (pid == 0)
        assert r["bcast"] == [10]


def test_task_group_mesh_carves_contiguous_groups(run):
    """Two groups of one rank: each rank's mesh is itself, at its group
    index; one group: both ranks, index 0."""
    results, _, _ = run
    for pid, r in results.items():
        assert r["groups"] == [[pid], pid]
        assert r["whole"] == [[0, 1], 0]


def test_training_reduces_loss_and_replicas_stay_identical(run):
    """The loss falls over the 3 steps, the loss stream and a parameter
    checksum are bit-equal across the ranks, and replicate() makes a
    rank-dependent model rank 0's on both."""
    results, _, _ = run
    r0, r1 = results[0], results[1]
    assert r0["losses"][-1] < r0["losses"][0], r0["losses"]
    assert r0["losses"] == r1["losses"]
    assert r0["checksum"] == r1["checksum"]
    for k, v in r0["arrays"].items():
        if not k.startswith("bn:"):  # each rank normalised its own half
            np.testing.assert_array_equal(v, r1["arrays"][k], err_msg=k)
    assert r0["replicated"] == r1["replicated"] == [1.0]


def _close_to_jax(arrays, prefix, want, start=None):
    """Parameters after Adam steps: at least 99.9% within 1e-5 (1e-3 lr)
    of the JAX ones, every one within 2 lr per step (a gradient near 0
    may take Adam's -lr g / (|g| + eps) to either sign); running
    statistics within 1e-5."""
    params, stats = want
    got = {k.split(":", 1)[1]: v for k, v in arrays.items()
           if k.startswith(prefix + ":")}
    assert set(got) == set(params) | set(stats)
    for k, v in stats.items():
        np.testing.assert_allclose(got[k], v, atol=1e-5, err_msg=k)
    diffs = np.concatenate([np.abs(got[k] - v).ravel()
                            for k, v in params.items()])
    assert diffs.max() <= 2 * LR * N_STEPS, diffs.max()
    assert (diffs <= 1e-5).mean() >= 0.999, (diffs <= 1e-5).mean()


def test_two_process_steps_match_the_jax_two_device_mesh(run):
    """2D: the loss of each of the 3 steps within 1e-5 relative of the JAX
    Trainer's on a 2-device mesh, the parameters and statistics after
    them as in _close_to_jax; one 3D and one multi-task step likewise
    (every task's loss)."""
    results, want, _ = run
    arrays = results[0]["arrays"]
    np.testing.assert_allclose(results[0]["losses"], want["losses"],
                               rtol=1e-5)
    _close_to_jax(arrays, "2d", want["2d"])
    np.testing.assert_allclose(results[0]["loss3d"], want["loss3d"],
                               rtol=1e-5)
    _close_to_jax(arrays, "3d", want["3d"])
    got = results[0]["lossmt"]
    assert set(got) == set(want["lossmt"])
    for k, v in want["lossmt"].items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)
    _close_to_jax(arrays, "mt", want["mt"])


@pytest.mark.parametrize("name", ["val", "val_pad"])
def test_multiprocess_validation_matches_single_process(run, name):
    """Validation over 2 ranks equals the JAX package's single-process
    Validation on the same global batches: val_loss within 1e-5 relative,
    val_dice within 1e-6. 'val': 3 rows per rank; 'val_pad': a global 5
    padded to 6, rank 1 holding 2 valid rows and a pad row that the
    counts leave out and the loss factor 6/5 undoes."""
    results, want, _ = run
    for r in results.values():
        got = r[name]
        assert got["padded"] == 6
        assert got["valid"] == (3 if name == "val" or r["pid"] == 0 else 2)
        np.testing.assert_allclose(got["val_loss"], want[name]["val_loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(got["val_dice"], want[name]["val_dice"],
                                   rtol=1e-6)


def test_global_batchnorm_matches_one_rank_on_the_concatenated_batch(run):
    """Two ranks' global BatchNorm (float32, each its half; loss sum(y r)
    over its rows) against a float64 oracle on the concatenated batch:
    y and dx within 1e-5, dw and db (summed over the ranks, as DDP's
    average of the per-rank sums is for mean losses) within 1e-4; the
    statistics within 1e-5. One rank on the whole batch in float32 meets
    the same bounds."""
    results, _, data = run
    x = torch.from_numpy(data["bn_x"]).double().requires_grad_()
    w = torch.from_numpy(data["bn_w"]).double().requires_grad_()
    b = torch.from_numpy(data["bn_b"]).double().requires_grad_()
    dims = (0, 2, 3)
    mean = x.mean(dim=dims)
    var = (x * x).mean(dim=dims) - mean * mean
    shape = (1, -1, 1, 1)
    y = ((x - mean.view(shape)) / torch.sqrt(var.view(shape) + 1e-3)
         * w.view(shape) + b.view(shape))
    (y * torch.from_numpy(data["bn_r"]).double()).sum().backward()
    oracle = {"y": y.detach().numpy(), "dx": x.grad.numpy(),
              "dw": w.grad.numpy(), "db": b.grad.numpy(),
              "mean": mean.detach().numpy(), "var": var.detach().numpy()}

    a0, a1 = results[0]["arrays"], results[1]["arrays"]
    two = {k: np.concatenate([a0[f"bn:{k}"], a1[f"bn:{k}"]])
           for k in ("y", "dx")}
    two.update({k: a0[f"bn:{k}"] + a1[f"bn:{k}"] for k in ("dw", "db")})
    two.update({k: a0[f"bn:{k}"] for k in ("mean", "var")})
    for k in ("mean", "var"):
        np.testing.assert_array_equal(a0[f"bn:{k}"], a1[f"bn:{k}"])

    xs = torch.from_numpy(data["bn_x"]).requires_grad_()
    ws = torch.from_numpy(data["bn_w"]).requires_grad_()
    bs = torch.from_numpy(data["bn_b"]).requires_grad_()
    ys, m1, v1 = _BatchStatsNorm.apply(xs, ws, bs, 1e-3, False)
    (ys * torch.from_numpy(data["bn_r"])).sum().backward()
    one = {"y": ys.detach().numpy(), "dx": xs.grad.numpy(),
           "dw": ws.grad.numpy(), "db": bs.grad.numpy(),
           "mean": m1.numpy(), "var": v1.numpy()}
    for got in (two, one):
        for k, v in oracle.items():
            tol = 1e-4 if k in ("dw", "db") else 1e-5
            np.testing.assert_allclose(got[k], v, atol=tol, rtol=tol,
                                       err_msg=k)


def test_explicit_multiprocess_startup_failure_raises(tmp_path):
    """An explicit 2-process configuration whose start-up fails (the peer
    never comes) raises RuntimeError, never runs the process alone."""
    code = (
        "from datetime import timedelta\n"
        "from multiplanarunet_tpu_torch.parallel.distributed import "
        "initialize_distributed, process_count\n"
        "try:\n"
        f"    initialize_distributed('localhost:{_free_port()}', 2, 0, "
        "device='cpu', timeout=timedelta(seconds=3))\n"
        "except RuntimeError as e:\n"
        "    print('RAISED', process_count(), str(e)[:80])\n"
        "else:\n"
        "    print('NO_RAISE')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env(), timeout=60, cwd=tmp_path)
    assert "RAISED 1 torch.distributed start-up failed" in out.stdout, (
        out.stdout, out.stderr[-2000:])


def test_mp_train_num_devices_pads_a_global_batch_of_3(tmp_path):
    """`mp train --num_devices 2 --device cpu` at batch_size 3 starts two
    ranks itself; the global batch pads to 4 as the JAX package's
    2-device mesh pads it (rank 0: 2 valid rows, rank 1: 1 valid and a
    weight-0 pad row); one CSV with a finite row per epoch, the weights
    written, rank 1's log beside rank 0's."""
    from multiplanarunet_tpu_torch.bin import init_project

    assert j_pad_batch_to_multiple(3, 2) == pad_batch_to_multiple(3, 2) == 4
    toy_data(tmp_path / "data", 3, 2, 32, 3)
    init_project.entry_func(["--name", "proj", "--root", str(tmp_path),
                             "--data_dir", str(tmp_path / "data")])
    proj = tmp_path / "proj"
    edit_yaml(proj / "train_hparams.yaml", (
        ("dim: Null", "dim: 32\n  init_filters: 8"),
        ("depth: 4", "depth: 2"),
        ("complexity_factor: 2", "complexity_factor: 1"),
        ("views: 6", "views: 3"),
        ("batch_size: 16", "batch_size: 3"),
        ("mixed_precision: True", "mixed_precision: False")))
    out = subprocess.run(
        [sys.executable, "-m", "multiplanarunet_tpu_torch.bin.mp", "train",
         "--project_dir", str(proj), "--device", "cpu", "--num_devices", "2",
         "--overwrite", "--no_images", "--epochs", "2",
         "--train_images_per_epoch", "6", "--val_images_per_epoch", "3"],
        capture_output=True, text=True, env=_env(), timeout=90)
    assert out.returncode == 0, out.stderr[-4000:]
    logs = proj / "logs"
    assert "global batch padded to 4; 2 valid here" in (
        logs / "train.txt").read_text()
    assert "global batch padded to 4; 1 valid here" in (
        logs / "train_rank1.txt").read_text()
    lines = (logs / "training.csv").read_text().splitlines()
    head = lines[0].split(",")
    assert len(lines) == 3
    for row in lines[1:]:
        row = dict(zip(head, row.split(",")))
        assert np.isfinite(float(row["loss"])) and np.isfinite(
            float(row["val_dice"]))
    assert (proj / "model" / "model_weights.npz").exists()
