"""Each rank of a data-parallel group gets its rows of the JAX package's
global batch (the one-process N-device run that `mp train --num_devices
N` stands for):

- the threefry draw from a start offset is the slice of the whole draw,
  bit for bit, across 2^32 too, and `uniform(..., rows=...)` is the slice
  of `jax.random.uniform` while drawing only its rows;
- seeded Elastic2D / Elastic3D augmenters, one per rank with its share
  set, deform together what the JAX augmenter deforms in one call over
  the global batch (batch 4 over 2 ranks, 3 padded to 4 over 2, 3 padded
  to 4 over 4 with one rank holding no valid row), and the Trainer sets
  the share on every task's augmenter of a MultiTaskSequence;
- two gloo ranks training at batch 3 through the Trainer give the padded
  global batch of the JAX `_shard` rule: the augmented rows, then the
  global batch's row 0 with weight 0.
"""
import functools
import json
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiplanarunet_tpu.augmentation.augmenters import Elastic2D as JElastic2D
from multiplanarunet_tpu.augmentation.augmenters import Elastic3D as JElastic3D
from multiplanarunet_tpu_torch.augmentation.augmenters import (
    Elastic2D,
    Elastic3D,
)
from multiplanarunet_tpu_torch.ops import prng
from multiplanarunet_tpu_torch.parallel import pad_batch_to_multiple
from multiplanarunet_tpu_torch.sequences.multi_task import MultiTaskSequence
from multiplanarunet_tpu_torch.train.trainer import Trainer
from tests.test_torch_distributed import REPO, launch
from tests.torch_projects import torch_threads  # noqa: F401


# The augmenters and tolerances of test_elastic2d_host_draws_match_jax
# and test_elastic3d_augmenter_draws_and_weights_match_jax
KINDS = {
    "2d": dict(port=Elastic2D, jax=JElastic2D, spatial=(16, 16),
               kw=dict(alpha=[0, 450], sigma=[20, 30], apply_prob=0.5,
                       seed=5),
               atol=1e-4, label_share=0.999),
    "3d": dict(port=Elastic3D, jax=JElastic3D, spatial=(8, 8, 8),
               kw=dict(alpha=[0, 450], sigma=[12, 25], apply_prob=0.5,
                       seed=3),
               atol=1e-5, label_share=0.9999),
}
N_BATCHES = 2


def _batches(kind, batch):
    """N_BATCHES seeded global batches (x, y, w) of `kind`'s shape."""
    rng = np.random.RandomState(batch)
    shape = (N_BATCHES, batch) + KINDS[kind]["spatial"] + (1,)
    return (rng.rand(*shape).astype(np.float32),
            rng.randint(0, 3, shape).astype(np.float32),
            np.ones((N_BATCHES, batch), np.float32))


@functools.cache
def _jax_global(kind, batch):
    """The JAX augmenter's output over each global batch, one call each,
    and its RandomState's state after them."""
    aug = KINDS[kind]["jax"](**KINDS[kind]["kw"])
    x, y, w = _batches(kind, batch)
    out = []
    for i in range(N_BATCHES):
        jx, jy, jw = aug(jnp.asarray(x[i]), jnp.asarray(y[i]), w[i],
                         np.zeros((batch, 1)))
        out.append((np.asarray(jx), np.asarray(jy), jw))
    return out, aug._rng.get_state()


# ------------------------------------------------------------ offset draws
@pytest.mark.parametrize("mode", [prng.BITS, prng.UNIFORM])
@pytest.mark.parametrize("offset,n", [(0, 50), (17, 33), (1000, 1)])
def test_offset_draw_is_the_slice_of_the_whole(mode, offset, n):
    key = prng.fold_in(prng.PRNGKey(9), 3)
    whole = prng.threefry2x32(key, offset + n, mode, 2.0, -1.0,
                              device="cpu")
    part = prng.threefry2x32(key, n, mode, 2.0, -1.0, device="cpu",
                             offset=offset)
    assert part.dtype == whole.dtype and part.shape == (n,)
    np.testing.assert_array_equal(part.view(torch.int32).numpy(),
                                  whole[offset:].view(torch.int32).numpy())


def test_offset_draw_across_two_to_the_32():
    """Indices 2^32 - 3 .. 2^32 + 2: the counter's high word turns over;
    each value is the XOR of threefry2x32 at the explicit (hi, lo)
    counter pair (`_hash_np`, which split and fold_in pin to JAX)."""
    key = prng.split(prng.PRNGKey(4), 3)[1]
    offset, n = 2 ** 32 - 3, 6
    i = np.arange(offset, offset + n, dtype=np.uint64)
    y0, y1 = prng._hash_np(key, (i >> np.uint64(32)).astype(np.uint32),
                           (i & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    got = prng.threefry2x32(key, n, prng.BITS, device="cpu", offset=offset)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), y0 ^ y1)
    u = prng.threefry2x32(key, n, prng.UNIFORM, 2.0, -1.0, device="cpu",
                          offset=offset)
    want = ((y0 ^ y1) >> np.uint32(9)) | np.uint32(0x3F800000)
    want = np.maximum(np.float32(-1), (want.view(np.float32) - 1)
                      * np.float32(2) + np.float32(-1))
    np.testing.assert_array_equal(u.numpy().view(np.uint32),
                                  want.view(np.uint32))


@pytest.mark.parametrize("shape,rows", [((6, 5, 7), (2, 5)),
                                        ((4, 3, 3, 3), (3, 4)),
                                        ((4, 8), (0, 4)),
                                        ((4, 8), (2, 2))])
def test_uniform_rows_are_the_rows_of_the_jax_draw(monkeypatch, shape, rows):
    """Bit for bit the rows of jax.random.uniform(key, shape, -1, 1), from
    a draw of the rows' values alone."""
    key = jax.random.fold_in(jax.random.PRNGKey(12), 2)
    want = np.asarray(jax.random.uniform(key, shape, minval=-1.0,
                                         maxval=1.0))[rows[0]:rows[1]]
    calls = []
    plain = prng.threefry2x32_reference

    def counted(key, n, mode, span, minval, scale, device, offset):
        calls.append((n, offset))
        return plain(key, n, mode, span, minval, scale, device, offset)

    monkeypatch.setattr(prng, "threefry2x32_reference", counted)
    got = prng.uniform(np.asarray(key), shape, -1.0, 1.0, device="cpu",
                       rows=rows)
    per_row = int(np.prod(shape[1:]))
    assert calls == [((rows[1] - rows[0]) * per_row, rows[0] * per_row)]
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    with pytest.raises(ValueError, match="outside"):
        prng.uniform(np.asarray(key), shape, device="cpu",
                     rows=(0, shape[0] + 1))


# ------------------------------------------------- rank shares, one process
def _rank_rows(batch, n_ranks, rank):
    """(first row, rows sampled, valid rows) of `rank`'s share, as
    Trainer._batch_share and _fit give them."""
    local = pad_batch_to_multiple(batch, n_ranks) // n_ranks
    valid = min(local, max(0, batch - rank * local))
    return rank * local, valid or local, valid


def _check_ranks_against_jax(kind, batch, n_ranks, outs):
    """outs[r][i]: rank r's (x, y, w) of batch i; their valid rows
    together must be the JAX augmenter's global output."""
    spec = KINDS[kind]
    want, _ = _jax_global(kind, batch)
    deformed_elsewhere = False
    for i, (jx, jy, jw) in enumerate(want):
        parts = []
        for r in range(n_ranks):
            first, _, valid = _rank_rows(batch, n_ranks, r)
            x, y, w = outs[r][i]
            parts.append((x[:valid], y[:valid], w[:valid]))
            deformed_elsewhere |= r > 0 and bool((w[:valid] != 1).any())
        x, y, w = (np.concatenate([p[k] for p in parts]) for k in range(3))
        np.testing.assert_array_equal(w, jw)
        np.testing.assert_allclose(x, jx, atol=spec["atol"])
        assert (y == jy).mean() >= spec["label_share"]
        changed = ~np.isclose(x, _batches(kind, batch)[0][i]).all(
            axis=tuple(range(1, x.ndim)))
        np.testing.assert_array_equal(changed, jw != 1.0)
    # The test shows a row deformed on a rank other than the first
    assert deformed_elsewhere


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("batch,n_ranks", [(4, 2), (3, 2), (3, 4)])
def test_ranks_together_draw_the_jax_global_batch(kind, batch, n_ranks):
    """One fresh seeded augmenter per rank, its share set: weights and
    apply masks exactly the JAX augmenter's over the global batch, images
    and labels within its parity tolerances; every rank's RandomState
    ends where the JAX augmenter's does (one global batch of draws per
    batch, on the rank with no valid row too)."""
    spec = KINDS[kind]
    x, y, w = _batches(kind, batch)
    _, jax_state = _jax_global(kind, batch)
    outs = []
    for r in range(n_ranks):
        first, n, _ = _rank_rows(batch, n_ranks, r)
        rows = slice(first, first + n) if first < batch else slice(0, n)
        aug = spec["port"](**spec["kw"])
        aug.share = (batch, first)
        outs.append([])
        for i in range(N_BATCHES):
            tx, ty, tw = aug(torch.from_numpy(x[i, rows]),
                             torch.from_numpy(y[i, rows]), w[i, rows],
                             np.zeros((n, 1)))
            assert tx.shape[0] == n
            outs[r].append((tx.numpy(), ty.numpy(), tw))
        state = aug._rng.get_state()
        np.testing.assert_array_equal(state[1], jax_state[1])
        assert state[2] == jax_state[2]
    _check_ranks_against_jax(kind, batch, n_ranks, outs)


class _TaskSequence:
    """A task's training sequence, as the Trainer sees it: its
    augmenters."""

    def __init__(self, kind):
        self.list_of_augmenters = [KINDS[kind]["port"](**KINDS[kind]["kw"])]


def test_trainer_shares_every_task_of_a_multitask_sequence():
    """Two tasks (2D and 3D boxes as stand-ins for two task samplers),
    batch 3 over 2 ranks: the Trainer's share reaches each task's
    augmenter (a MultiTaskSequence sends an attribute read to task 0
    alone), each task's ranks then draw the JAX global batch, and the
    share is cleared again."""
    batch, n_ranks = 3, 2
    outs = {kind: [] for kind in KINDS}
    for r in range(n_ranks):
        first, n, _ = _rank_rows(batch, n_ranks, r)
        seq = MultiTaskSequence([_TaskSequence(k) for k in sorted(KINDS)],
                                sorted(KINDS), no_log=True)
        Trainer._share_augmenters(seq, (batch, first))
        for kind, task in zip(sorted(KINDS), seq.sequences):
            aug = task.list_of_augmenters[0]
            assert aug.share == (batch, first)
            x, y, w = _batches(kind, batch)
            outs[kind].append([
                tuple(t.numpy() if torch.is_tensor(t) else t for t in aug(
                    torch.from_numpy(x[i, first:first + n]),
                    torch.from_numpy(y[i, first:first + n]),
                    w[i, first:first + n], np.zeros((n, 1))))
                for i in range(N_BATCHES)])
        Trainer._share_augmenters(seq, None)
        assert all(t.list_of_augmenters[0].share is None
                   for t in seq.sequences)
    for kind in KINDS:
        _check_ranks_against_jax(kind, batch, n_ranks, outs[kind])


def test_no_share_draws_the_local_batch_as_before():
    """No share set: the augmenter draws for its own batch alone, the
    one-process path (the same output as a share of (B, 0))."""
    x, y, w = _batches("2d", 4)
    plain, shared = Elastic2D(**KINDS["2d"]["kw"]), Elastic2D(
        **KINDS["2d"]["kw"])
    shared.share = (4, 0)
    for i in range(N_BATCHES):
        a, b = (aug(torch.from_numpy(x[i]), torch.from_numpy(y[i]), w[i],
                    np.zeros((4, 1))) for aug in (plain, shared))
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2])
    with pytest.raises(ValueError, match="does not fit"):
        shared.share = (4, 2)
        shared(torch.from_numpy(x[0]), None)


# ------------------------------------------------------ two gloo ranks
GLOO_BATCH = 3
WORKER = textwrap.dedent(r"""
    import json, os, sys
    import numpy as np
    import torch

    torch.set_num_threads(1)
    out = sys.argv[1]
    data = dict(np.load(os.path.join(out, "data.npz")))
    kw = json.loads(sys.argv[2])

    from multiplanarunet_tpu_torch.augmentation.augmenters import Elastic2D
    from multiplanarunet_tpu_torch.logging.loggers import ScreenLogger
    from multiplanarunet_tpu_torch.models.unet import UNet
    from multiplanarunet_tpu_torch.parallel import (
        maybe_initialize_distributed, process_barrier,
    )
    from multiplanarunet_tpu_torch.train.trainer import Trainer

    cpu = torch.device("cpu")
    n, pid = maybe_initialize_distributed(device=cpu)
    batch = data["x"].shape[1]
    local = -(-batch // n)


    class Injected:
        # This rank's rows of fixed global batches, through its augmenter
        batch_size = None

        def __init__(self):
            self.list_of_augmenters = [Elastic2D(**kw)]

        def __getitem__(self, i):
            rows = slice(pid * local, pid * local + self.batch_size)
            x, y = (torch.from_numpy(data[k][i, rows]) for k in "xy")
            w = np.ones(len(x), np.float32)
            for aug in self.list_of_augmenters:
                x, y, w = aug(x, y, w, np.zeros((len(x), 1)))
            return x, y[..., None], w


    trainer = Trainer(UNet(3, 1, depth=1, init_filters=4),
                      logger=ScreenLogger(False), device=cpu,
                      pad_global_batch=True)
    trainer.compile_model("Adam", {"lr": 1e-3},
                          loss="SparseCategoricalCrossentropy", metrics=[])
    step, seen = trainer.train_step, []

    def recorded(X, y, w):
        seen.append((X.numpy().copy(), y.numpy().copy(),
                     np.asarray(w).copy()))
        return step(X, y, w)

    trainer.train_step = recorded
    seq = Injected()
    history = trainer.fit(seq, None, batch_size=batch, n_epochs=1,
                          train_im_per_epoch=batch * data["x"].shape[0],
                          verbose=False, no_im=True)
    np.savez(os.path.join(out, f"rank{pid}.npz"),
             **{f"{k}{i}": s[j] for i, s in enumerate(seen)
                for j, k in enumerate("xyw")})
    process_barrier("worker-end")
    print("RESULT " + json.dumps({
        "steps": len(seen), "loss": history[0]["loss"],
        "share_after": seq.list_of_augmenters[0].share}))
""")


def test_two_gloo_ranks_train_on_the_jax_padded_global_batch(tmp_path):
    """batch 3 over 2 gloo ranks through Trainer.fit with a seeded
    Elastic2D: the ranks' padded shares together are the JAX augmenter's
    output over the 3 rows, then its row 0 (X[:pad] of
    multiplanarunet_tpu/train/trainer.py's _shard) with weight 0; weights
    exactly, images within 1e-4, labels on >= 0.999 of pixels."""
    x, y, _ = _batches("2d", GLOO_BATCH)
    np.savez(tmp_path / "data.npz", x=x, y=y)
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    outs = launch(script, [str(tmp_path), json.dumps(KINDS["2d"]["kw"])],
                  2, cwd=REPO)
    results = [json.loads(o.split("RESULT ", 1)[1]) for o in outs]
    assert all(r["steps"] == N_BATCHES and r["share_after"] is None
               and np.isfinite(r["loss"]) for r in results)
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    want, _ = _jax_global("2d", GLOO_BATCH)
    for i, (jx, jy, jw) in enumerate(want):
        pad = pad_batch_to_multiple(GLOO_BATCH, 2) - GLOO_BATCH
        jx, jy = np.concatenate([jx, jx[:pad]]), np.concatenate([jy, jy[:pad]])
        jw = np.concatenate([jw, np.zeros(pad, np.float32)])
        gx, gy, gw = (np.concatenate([r[f"{k}{i}"] for r in ranks])
                      for k in "xyw")
        np.testing.assert_array_equal(gw, jw)
        np.testing.assert_allclose(gx, jx, atol=1e-4)
        assert (gy[..., 0] == jy).mean() >= 0.999
        # The pad row is rank 0's row 0, bit for bit
        np.testing.assert_array_equal(ranks[1][f"x{i}"][1],
                                      ranks[0][f"x{i}"][0])
