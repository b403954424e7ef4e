"""The port's Swin UNETR (`models/swin_unetr.py`, no JAX counterpart)
against the benchmark's plain reference (`portbench/reference/
swin_unetr.py`) at a small size on the CPU: feature size 12, heads (3, 6,
12, 24), 32^3 boxes, batch 2, 3 classes. At 32^3 the first two stages
(16^3, 8^3) are padded to the 7^3 window and shifted, the last two (4^3,
2^3) attend over their whole grid. Seeded weights (`swin_init`) are
copied into the reference by name. Also: the shift mask and the padding
against hand-built cases, `SparseDiceCELoss` against its formula, bf16
against the reference with the fp8 control outside the same bound, the
checkpoint round trip, and `mp train` then `mp predict_3D` on a tiny
project."""

import itertools
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from multiplanarunet_tpu_torch.evaluate.losses import (
    LOSSES,
    SparseDiceCELoss,
)
from multiplanarunet_tpu_torch.models import checkpoint
from multiplanarunet_tpu_torch.models.model_init import (
    build_model,
    load_unet_weights,
)
from multiplanarunet_tpu_torch.models.swin_unetr import (
    MASK_VALUE,
    SwinBlock,
    SwinUNETR,
    shift_mask,
    swin_init,
)
from multiplanarunet_tpu_torch.train.optimizers import AdamW
from portbench.reference import swin_unetr as ref

F_, N_CLASSES, DIM, BATCH = 12, 3, 32, 2
BUILD = {"model_class_name": "SwinUNETR", "n_classes": N_CLASSES,
         "n_channels": 1, "feature_size": F_, "dim": DIM}
# float32 through ~40 layers of convs, linears and softmaxes in another
# order of summation: round-off of a few ulps a layer
F32_TOL = 1e-5
# bf16 convs, linears and attention (8-bit mantissa, 2^-8 = 0.4% a
# rounding) against the float32 reference, the logits' relative error
# over the batch: 0.7% measured; computing in fp8 (3-bit mantissa) reads
# 8.6%, well outside
BF16_REL = 0.02


def _model(dtype=torch.float32):
    torch.manual_seed(0)
    model = SwinUNETR(N_CLASSES, 1, feature_size=F_, dim=DIM, dtype=dtype)
    return swin_init(model, seed=0, device="cpu")


@pytest.fixture(scope="module")
def model():
    return _model()


def _params(model):
    return {k: v.detach().clone() for k, v in model.named_parameters()}


def _x(seed=1, shape=(BATCH, 1, DIM, DIM, DIM)):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def _logits(model, x):
    model.out_act = lambda z: z
    try:
        return model(x)
    finally:
        model.out_act = lambda z: torch.softmax(z, dim=1)


def test_forward_matches_reference(model):
    x = _x()
    with torch.no_grad():
        got = model.train()(x)
        want = ref.forward(_params(model), x)
        assert (got - want).abs().max() < F32_TOL
        # a grid whose sides differ: stage 1 at 32 x 16 x 16, shifted on
        # every axis, padded to 35 x 21 x 21
        x2 = _x(2, (1, 1, 64, 32, 32))
        assert (model(x2) - ref.forward(_params(model), x2)).abs().max() \
            < F32_TOL
    assert ref.config_of(_params(model)) == (F_, [2] * 4, [3, 6, 12, 24], 7)
    assert sum(p.numel() for p in model.parameters()) == 4078077


def test_gradients_and_one_adamw_step(model):
    x = _x(3).movedim(1, -1)
    y = torch.randint(0, N_CLASSES, (BATCH, DIM, DIM, DIM, 1),
                      generator=torch.Generator().manual_seed(4))
    w = torch.tensor([1.0, 0.5])
    opt_args = (1e-3, 0.9, 0.999, 1e-8, 1e-2)
    losses, grad, after = ref.train_steps(_params(model), [(x, y, w)],
                                          opt_args)
    net = _model()
    opt = AdamW(list(net.parameters()), learning_rate=1e-3, b1=0.9,
                b2=0.999, eps=1e-8, weight_decay=1e-2)
    out = net.train()(x.movedim(-1, 1)).movedim(1, -1)
    loss = SparseDiceCELoss()(y, out, sample_weight=w)
    assert abs(float(loss.detach()) - losses[0]) < 1e-5 * abs(losses[0])
    loss.backward()
    # Each leaf's error relative to the larger of its norm and the median
    # leaf's (as the benchmark's check reads them). Float32 round-off in
    # another order of summation: the gradients 4.5e-4 at most, where an
    # InstanceNorm's backward cancels most of a small gradient
    # (encoder1.conv3); Adam's first step, sign-like, amplifies that to
    # 2.1e-3 of the update of that leaf
    median = float(np.median([float(g.norm()) for g in grad.values()]))
    for name, p in net.named_parameters():
        g = grad[name]
        scale = max(float(g.norm()), median)
        assert float((p.grad - g).norm()) / scale < 2e-3, name
    p0 = _params(model)
    opt.step()
    moves = {n: after[n] - p0[n] for n in p0}
    median = float(np.median([float(d.norm()) for d in moves.values()]))
    for name, p in net.named_parameters():
        d = moves[name]
        err = float((p.detach() - p0[name] - d).norm())
        assert err / max(float(d.norm()), median) < 1e-2, name


def test_shift_mask_against_hand_built():
    """A 4^3 grid, window 2, shift 1: the cuts at 2 and 3 give each axis
    the regions {0, 1}, {2}, {3}; two tokens of a window are masked
    where any coordinate lies in different regions."""
    mask = shift_mask((4, 4, 4), (2, 2, 2), (1, 1, 1))
    region = {0: 0, 1: 0, 2: 1, 3: 2}
    windows = list(itertools.product(range(2), repeat=3))
    offsets = list(itertools.product(range(2), repeat=3))
    assert mask.shape == (8, 8, 8)
    for w, (a, b, c) in enumerate(windows):
        toks = [(2 * a + i, 2 * b + j, 2 * c + k) for i, j, k in offsets]
        for s, t1 in enumerate(toks):
            for t, t2 in enumerate(toks):
                same = all(region[u] == region[v] for u, v in zip(t1, t2))
                assert float(mask[w, s, t]) == (0.0 if same else MASK_VALUE)
    # the last window holds tokens of all eight region combinations
    assert int((mask[-1] == 0).sum()) == 8
    assert int((mask[0] == 0).sum()) == 64


def test_padding_against_hand_built():
    """A 3^3 grid and window 2 pad to 4^3 with zero tokens after the norm.
    With q = k = 0 and no bias each token takes the mean of its window's
    values, padded tokens (whose value is the value bias) included."""
    torch.manual_seed(5)
    block = SwinBlock(4, heads=2, window=2, shifted=False)
    with torch.no_grad():
        block.attn.qkv.weight[:8] = 0.0
        block.attn.qkv.bias[:8] = 0.0
        block.attn.relative_position_bias_table.zero_()
        block.attn.proj.weight.copy_(torch.eye(4))
        block.attn.proj.bias.zero_()
    x = torch.randn(1, 3, 3, 3, 4)
    plan = ((2, 2, 2), (0, 0, 0), (4, 4, 4), None)
    with torch.no_grad():
        got = block.attend(x, plan)
        normed = torch.nn.functional.layer_norm(x, (4,), block.norm1.weight,
                                                block.norm1.bias, 1e-5)
        wv = block.attn.qkv.weight[8:]
        bv = block.attn.qkv.bias[8:]
        v = normed @ wv.T + bv
        for i, j, k in itertools.product(range(3), repeat=3):
            lo = [2 * (c // 2) for c in (i, j, k)]
            real = v[0, lo[0]:lo[0] + 2, lo[1]:lo[1] + 2, lo[2]:lo[2] + 2]
            n_real = real.shape[0] * real.shape[1] * real.shape[2]
            want = (real.reshape(-1, 4).sum(0) + (8 - n_real) * bv) / 8
            assert torch.allclose(got[0, i, j, k], want, atol=1e-6)


def test_dice_ce_against_formula():
    rng = np.random.RandomState(0)
    logits = rng.randn(3, 5, 6, 4, N_CLASSES)
    p = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    y = rng.randint(0, N_CLASSES, (3, 5, 6, 4, 1))
    w = np.array([1.0, 0.2, 2.0])
    g = np.eye(N_CLASSES)[y[..., 0]]
    ce = -np.log(np.clip((p * g).sum(-1), 1e-8, 1 - 1e-8)).mean((1, 2, 3))
    inter = (p * g).sum((1, 2, 3))
    den = (p * p).sum((1, 2, 3)) + g.sum((1, 2, 3)) + 1e-6
    dice = (1 - 2 * inter / den).mean(-1)
    want = ((ce + dice) * w).mean()
    got = LOSSES["SparseDiceCELoss"]()(torch.from_numpy(y),
                                       torch.from_numpy(p),
                                       sample_weight=w)
    assert abs(float(got) - want) < 1e-10
    # the reference's channels-first form agrees
    r = ref.dice_ce(torch.from_numpy(p).movedim(-1, 1),
                    torch.from_numpy(y[..., 0]), torch.from_numpy(w))
    assert abs(float(r) - want) < 1e-10


def test_bf16_within_bound_and_fp8_outside(model):
    x = _x(6)
    p = _params(model)
    bf16 = SwinUNETR(N_CLASSES, 1, feature_size=F_, dtype=torch.bfloat16)
    bf16.load_state_dict(model.state_dict())
    with torch.no_grad():
        want = ref.forward(p, x, logits=True)

        def rel(z):
            return float((z.float() - want).norm() / want.norm())

        assert rel(_logits(bf16.train(), x)) < BF16_REL
        assert rel(ref.forward(p, x, quant="fp8", logits=True)) > BF16_REL


def test_refuses_bad_shapes():
    with pytest.raises(ValueError, match="multiple of 32"):
        SwinUNETR(3, 1, feature_size=12, dim=48)
    with pytest.raises(ValueError, match="heads"):
        SwinUNETR(3, 1, feature_size=10)
    with pytest.raises(ValueError, match="multiples of 32"):
        SwinUNETR(3, 1, feature_size=12)(torch.zeros(1, 1, 32, 32, 48))


def test_checkpoint_round_trip(model, tmp_path):
    path = tmp_path / "model_weights.npz"
    checkpoint.save_unet_weights(path, model)
    params, stats, _ = checkpoint.load_weights(path)
    assert stats == {}
    assert params["out_conv"]["weight"].shape == (N_CLASSES, F_, 1, 1, 1)
    other = build_model(BUILD)
    load_unet_weights(other, path)
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              other.state_dict().items()):
        assert torch.equal(a, b), k
    fresh = build_model(BUILD)
    n = checkpoint.restore_by_name(fresh, params, stats)
    assert n == len(list(model.parameters()))
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 fresh.parameters()))


PRESET_3D = (Path(__file__).resolve().parents[1]
             / "multiplanarunet_tpu_torch" / "bin" / "defaults" / "3D"
             / "train_hparams.yaml")


def test_mp_train_then_predict_3d(tmp_path):
    from multiplanarunet_tpu_torch.bin import mp
    from multiplanarunet_tpu_torch.bin.toy_data import create_dataset

    rng = np.random.RandomState(5)
    create_dataset(tmp_path / "data" / "train", 2, 32, 1, rng, "train")
    create_dataset(tmp_path / "data" / "val", 1, 32, 1, rng, "val")
    text = PRESET_3D.read_text()
    for old, new in (
            ("train_data: &TRAINDATA\n  base_dir: Null",
             f"train_data: &TRAINDATA\n  base_dir: "
             f"{tmp_path / 'data' / 'train'}"),
            ("val_data: &VALDATA\n  base_dir: Null",
             f"val_data: &VALDATA\n  base_dir: {tmp_path / 'data' / 'val'}"),
            ("test_data: &TESTDATA\n  base_dir: Null",
             f"test_data: &TESTDATA\n  base_dir: "
             f"{tmp_path / 'data' / 'val'}"),
            ('model_class_name: "UNet3D"', 'model_class_name: "SwinUNETR"'),
            ("real_box_dim: Null", f"real_box_dim: {DIM}"),
            ("\n  dim: Null", f"\n  dim: {DIM}\n  feature_size: {F_}"),
            ('loss: "SparseCategoricalCrossentropy"',
             'loss: "SparseDiceCELoss"'),
            ('optimizer: "Adam"', 'optimizer: "AdamW"'),
            ("batch_size: 16", f"batch_size: {BATCH}"),
            ("mixed_precision: True", "mixed_precision: False")):
        assert old in text, old
        text = text.replace(old, new)
    proj = tmp_path / "proj"
    proj.mkdir()
    (proj / "train_hparams.yaml").write_text(text)
    cwd = os.getcwd()
    try:
        mp.entry_func(["train", "--project_dir", str(proj), "--device",
                       "cpu", "--overwrite", "--no_images", "--epochs", "2",
                       "--train_images_per_epoch", "4",
                       "--val_images_per_epoch", "2"])
        log = (proj / "logs" / "train.txt").read_text()
        assert "Sampler: pooled path (isotropic 3D boxes" in log
        params, _, _ = checkpoint.load_weights(proj / "model"
                                               / "model_weights.npz")
        assert "swinViT" in params and "decoder1" in params
        mp.entry_func(["predict_3D", "--project_dir", str(proj), "--device",
                       "cpu", "--overwrite"])
    finally:
        os.chdir(cwd)
    out = proj / "predictions_3D"
    assert (out / "nii_files" / "val_000" / "PRED.nii.gz").exists()
    assert (out / "csv" / "results.csv").exists()
