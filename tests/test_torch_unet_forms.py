"""The U-Net's inference forms in the port against the JAX package's:
upsample2x, DilatedUpConv and SubpixelUpConv alone (2D and 3D), the
UNet's dilated_upconv / subpixel_decoder / predict_fused_bn /
predict_skip_bn / lane_pad fields in eval and train mode, UNet3D's two
decoder forms, lane_pad_variables after the weight carry, the decoders'
gradients, the predictor's choice of form (MultiViewPredictor against the
JAX one's rule) and build_model's fields (a JAX checkpoint trained with
lane_pad: 8). Small sizes: depth 2, init_filters 8, cf 2 (filters 11, 22,
45: no multiple of 8), float32, weights carried by
`unet_state_dict_from_jax`."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multiplanarunet_tpu.models import checkpoint as jckpt
from multiplanarunet_tpu.models import model_init as jinit
from multiplanarunet_tpu.models import unet as junet
from multiplanarunet_tpu.models.unet3d import UNet3D as JUNet3D
from multiplanarunet_tpu.utils.fusion import (
    MultiViewPredictor as JMultiViewPredictor,
)
from multiplanarunet_tpu_torch.models import checkpoint as tckpt
from multiplanarunet_tpu_torch.models import model_init as tinit
from multiplanarunet_tpu_torch.models.unet import (
    DilatedUpConv,
    SubpixelUpConv,
    UNet,
    glorot_init,
    lane_pad_variables,
    upsample2x,
)
from multiplanarunet_tpu_torch.models.unet3d import UNet3D
from multiplanarunet_tpu_torch.utils.fusion.fuse_and_predict import (
    MultiViewPredictor,
)
from tests.torch_projects import torch_threads  # noqa: F401


KW = dict(n_classes=3, n_channels=2, depth=2, complexity_factor=2.0,
          init_filters=8)
HW = 30  # pools to 15 and 7: both decoder levels crop their skip
CPU = torch.device("cpu")


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).movedim(-1, 1)


def _nhwc(t):
    return t.movedim(1, -1).detach().numpy()


def _variables(model, seed):
    """Random variables for `model`'s flax twin as numpy (params,
    batch_stats) trees: glorot kernels, random biases, BatchNorm
    parameters and statistics (drawn on the port's model, which is
    cheaper than a flax init)."""
    glorot_init(model, seed, device="cpu")
    rng = np.random.RandomState(seed)
    positive = ("running_var", "bn.weight", "bn_up.weight")
    with torch.no_grad():
        for key, t in model.state_dict().items():
            if t.dim() == 1:  # biases, BatchNorm weight / bias / stats
                draw = (0.5 + rng.rand(*t.shape) if key.endswith(positive)
                        else 0.1 * rng.randn(*t.shape))
                t.copy_(torch.from_numpy(draw.astype(np.float32)))
    return tckpt.unet_variables_from_model(model)


def _carried(cls, params, stats, **kw):
    """The port's model of class `cls` loaded from the flax trees."""
    model = cls(**kw)
    model.load_state_dict(tckpt.unet_state_dict_from_jax(params, stats,
                                                         model))
    return model


@pytest.fixture(scope="module")
def unet2d():
    """The unpadded flax UNet's variables and the port's model on them."""
    jmodel = junet.UNet(dim=HW, **KW)
    params, stats = _variables(UNet(**KW), seed=0)
    model = _carried(UNet, params, stats, **KW)
    x = np.random.RandomState(1).randn(3, HW, HW, 2).astype(np.float32)
    return jmodel, {"params": params, "batch_stats": stats}, model, x


# -------------------------------------------------------- building blocks
def _jax_upsample3d(x):
    """The JAX UNet3D's inline nearest 2x upsample."""
    B, D, H, W, C = x.shape
    return jnp.broadcast_to(x[:, :, None, :, None, :, None, :],
                            (B, D, 2, H, 2, W, 2, C)).reshape(
        B, 2 * D, 2 * H, 2 * W, C)


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("form", ["upsample2x", "DilatedUpConv",
                                  "SubpixelUpConv"])
def test_block_matches_jax(form, ndim):
    """Each block on a 5 x 7 (x 6) input of 3 channels, within 1e-5 of
    the JAX block on the same kernel and bias."""
    rng = np.random.RandomState(ndim)
    x = rng.randn(2, *(5, 7, 6)[:ndim], 3).astype(np.float32)
    if form == "upsample2x":
        want = (junet.upsample2x if ndim == 2 else _jax_upsample3d)(
            jnp.asarray(x))
        got = upsample2x(_nchw(x))
    else:
        kernel = rng.randn(*(2,) * ndim, 3, 4).astype(np.float32)
        bias = rng.randn(4).astype(np.float32)
        jmod = getattr(junet, form)(4, ndim=ndim)
        want = jmod.apply({"params": {"kernel": kernel, "bias": bias}},
                          jnp.asarray(x))
        mod = {"DilatedUpConv": DilatedUpConv,
               "SubpixelUpConv": SubpixelUpConv}[form](3, 4, ndim)
        with torch.no_grad():  # flax (*k, I, O) -> torch (O, I, *k)
            mod.weight.copy_(torch.from_numpy(kernel).permute(
                ndim + 1, ndim, *range(ndim)))
            mod.bias.copy_(torch.from_numpy(bias))
        with torch.no_grad():
            got = mod(_nchw(x))
    assert got.shape[2:] == tuple(2 * s for s in x.shape[1:-1])
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5)


# ------------------------------------------------------------- the UNet
FIELDS = [
    {"dilated_upconv": True},
    {"subpixel_decoder": True},
    {"predict_fused_bn": True},
    {"predict_skip_bn": True},
    {"lane_pad": 8},
    {"lane_pad": 8, "dilated_upconv": True},
    {"lane_pad": 16},
    {"lane_pad": 16, "dilated_upconv": True},
]
_ids = ["-".join(f"{k}={v}" for k, v in f.items()) for f in FIELDS]


def _pair(unet2d, fields):
    """(flax model, its variables, port model) with `fields` set; a
    lane-padded pair gets each package's lane_pad_variables."""
    jmodel, variables, model, _ = unet2d
    jm = jmodel.copy(**fields)
    tm = model.copy(**fields)
    state = model.state_dict()
    if "lane_pad" in fields:
        variables = junet.lane_pad_variables(jmodel, variables,
                                             fields["lane_pad"])
        state = lane_pad_variables(model, state, fields["lane_pad"])
    tm.load_state_dict(state)
    return jm, variables, tm


@pytest.mark.parametrize("fields", FIELDS, ids=_ids)
def test_unet_field_eval_matches_jax(unet2d, fields):
    """Eval mode, within 2e-5 of the flax model with the same field."""
    x = unet2d[3]
    jm, variables, tm = _pair(unet2d, fields)
    want = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = tm.eval()(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("fields", FIELDS, ids=_ids)
def test_unet_field_train_mode_matches_jax(unet2d, fields):
    """Train mode (batch statistics): the updated running statistics
    within 1e-5 of flax's, and the output within 1e-5 of the port's plain
    model in train mode and within 2e-5 of flax's. Normalising by batch
    statistics amplifies the float32 rounding order: the two packages'
    plain decoders already lie 1.3e-5 apart here, as the 3D train-mode
    test finds. The BatchNorm fields act in eval mode only."""
    _, _, model, x = unet2d
    jm, variables, tm = _pair(unet2d, fields)
    out, mutated = jm.apply(variables, jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
    with torch.no_grad():
        got = tm.train()(_nchw(x))
        plain = model.copy()
        plain.load_state_dict(model.state_dict())
        want = plain.train()(_nchw(x))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    np.testing.assert_allclose(_nhwc(got), np.asarray(out), atol=2e-5)
    want = tckpt.flatten(jax.tree.map(np.asarray,
                                      dict(mutated["batch_stats"])))
    got_s = tckpt.flatten(tckpt.unet_variables_from_model(tm)[1])
    assert set(got_s) == set(want)
    for k in want:
        np.testing.assert_allclose(got_s[k], want[k], atol=1e-5, err_msg=k)


@pytest.mark.parametrize("fields", [{"dilated_upconv": True},
                                    {"subpixel_decoder": True}],
                         ids=["dilated", "subpixel"])
def test_unet3d_decoder_form_matches_jax(fields):
    """UNet3D with either decoder form, eval mode, 18^3 (crops at both
    levels), within 1e-5 of the flax UNet3D with that field."""
    kw = dict(n_classes=3, n_channels=1, depth=2, complexity_factor=2.0,
              init_filters=4)
    jm = JUNet3D(dim=18, **kw, **fields)
    params, stats = _variables(UNet3D(**kw), seed=3)
    tm = _carried(UNet3D, params, stats, **kw, **fields)
    x = np.random.RandomState(4).randn(2, 18, 18, 18, 1).astype(np.float32)
    want = jm.apply({"params": params, "batch_stats": stats},
                    jnp.asarray(x), train=False)
    with torch.no_grad():
        got = tm.eval()(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("lane_pad", [8, 16])
def test_lane_pad_variables_bit_equal_to_jax(unet2d, lane_pad):
    """The port's embedding of the carried state dict equals the JAX
    embedding carried afterwards, bit for bit, key for key."""
    jmodel, variables, model, _ = unet2d
    got = lane_pad_variables(model, model.state_dict(), lane_pad)
    padded = jmodel.copy(lane_pad=lane_pad)
    jv = junet.lane_pad_variables(jmodel, variables, lane_pad)
    want = tckpt.unet_state_dict_from_jax(jv["params"], jv["batch_stats"],
                                          model.copy(lane_pad=lane_pad))
    assert padded.lane_pad == lane_pad
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    # every internal filter count is now a multiple
    assert got["encoder_L0.conv1.weight"].shape[0] % lane_pad == 0
    assert got["decoder_L1.conv1.weight"].shape[1] == 2 * 16
    # the embedding reads an unpadded model's weights only
    with pytest.raises(ValueError, match="unpadded"):
        lane_pad_variables(model.copy(lane_pad=8), got, lane_pad)


@pytest.mark.parametrize("form", ["dilated_upconv", "subpixel_decoder"])
def test_decoder_form_gradients_equal_naive(unet2d, form):
    """Train-mode gradients of every parameter, with either decoder form,
    within 1e-5 of the naive decoder's on the same weights and loss (a
    weighted mean of the probabilities, as the training losses are
    means)."""
    _, _, model, x = unet2d
    w = torch.from_numpy(np.random.RandomState(6).randn(3, 3, 28, 28)
                         .astype(np.float32))
    grads = []
    for m in (model.copy(), model.copy(**{form: True})):
        m.load_state_dict(model.state_dict())
        m.train()
        (m(_nchw(x)) * w).mean().backward()
        grads.append({k: p.grad for k, p in m.named_parameters()})
    assert set(grads[0]) == set(grads[1])
    for k in grads[0]:
        np.testing.assert_allclose(grads[1][k].numpy(), grads[0][k].numpy(),
                                   atol=1e-5, err_msg=k)


# ------------------------------------------------------ the predictor's rule
def _predictors(jmodel, variables, model):
    jp = JMultiViewPredictor(jmodel, variables, sample_dim=32,
                             real_space_span=31.0, n_classes=3)
    tp = MultiViewPredictor(model, sample_dim=32, real_space_span=31.0,
                            n_classes=3, device=CPU)
    return jp, tp


@pytest.mark.parametrize("cf,env,dilated,pad", [
    (2.0, {}, True, 8),
    (1.0, {}, True, 0),
    (2.0, {"MP_PREDICT_DILATED": "0"}, False, 8),
    (2.0, {"MP_PREDICT_LANE_PAD": "0"}, True, 0),
    (2.0, {"MP_PREDICT_LANE_PAD": "16"}, True, 16),
])
def test_predictor_form_follows_jax_rule(unet2d, monkeypatch, cf, env,
                                         dilated, pad):
    """The predictor runs the form the JAX predictor runs: dilated unless
    turned off, lane-padded to MP_PREDICT_LANE_PAD (8) only where the
    ladder holds a count that is not a multiple (cf=1's 8, 16, 32 is
    not padded). It computes what the caller's model computes, on a twin:
    the caller's model, its fields and its state dict are unchanged."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jmodel, variables, model, x = unet2d
    if cf != KW["complexity_factor"]:
        kw = {**KW, "complexity_factor": cf}
        jmodel = jmodel.copy(complexity_factor=cf)
        params, stats = _variables(UNet(**kw), seed=5)
        variables = {"params": params, "batch_stats": stats}
        model = _carried(UNet, params, stats, **kw)
    model.eval()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    jp, tp = _predictors(jmodel, variables, model)
    assert (jp.model.dilated_upconv, jp.model.lane_pad) == (dilated, pad)
    assert (tp.model.dilated_upconv, tp.model.lane_pad) == (dilated, pad)
    assert isinstance(tp.model.decoder_L0_conv_up, DilatedUpConv) == dilated
    assert (tp.model is model) == (not dilated and not pad)
    assert not model.dilated_upconv and model.lane_pad == 0
    assert not tp.model.training
    after = model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    with torch.no_grad():
        want = model(_nchw(x[:1, :16, :16]))
        got = tp.model(_nchw(x[:1, :16, :16]))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_predictor_pads_no_unet3d_and_keeps_other_models():
    """A UNet3D gets the dilated decoder but no lane padding (the JAX
    rule names the 2D UNet's class exactly); an oracle model runs as it
    is."""
    m3 = UNet3D(3, 1, depth=2, complexity_factor=2.0, init_filters=8)
    tp = MultiViewPredictor(m3, sample_dim=16, real_space_span=15.0,
                            n_classes=3, device=CPU)
    assert type(tp.model) is UNet3D and tp.model is not m3
    assert tp.model.dilated_upconv and tp.model.lane_pad == 0
    assert not m3.dilated_upconv
    oracle = torch.nn.Identity()
    tp = MultiViewPredictor(oracle, sample_dim=16, real_space_span=15.0,
                            n_classes=3, device=CPU)
    assert tp.model is oracle


# ------------------------------------------------------------- build_model
BUILD = {"model_class_name": "UNet", "n_classes": 3, "n_channels": 2,
         "dim": HW, "depth": 2, "complexity_factor": 2.0, "init_filters": 8,
         "out_activation": "softmax", "l1_reg": False, "l2_reg": False,
         "biased_output_layer": True}


def test_build_model_loads_jax_checkpoint_trained_with_lane_pad(tmp_path):
    """A build group with lane_pad: 8: the JAX build_model +
    init_model_variables + save_weights checkpoint (padded kernels) loads
    into the port's build_model + load_unet_weights, and the port
    predicts what JAX predicts (within 2e-5)."""
    build = {**BUILD, "lane_pad": 8}
    jm = jinit.build_model(build)
    variables = jinit.init_model_variables(jm)
    path = tmp_path / "model_weights.npz"
    jckpt.save_weights(path, variables["params"], variables["batch_stats"])
    tm = tinit.build_model(build)
    assert tm.lane_pad == 8
    tinit.load_unet_weights(tm, path)
    assert tm.encoder_L0.conv1.weight.shape[0] == 16
    x = np.random.RandomState(7).randn(2, HW, HW, 2).astype(np.float32)
    want = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = tm(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=2e-5)


def test_build_model_honours_the_jax_fields(unet2d):
    """predict_skip_bn (and the other forms) reach the port's UNet and
    it computes what the flax model built from the same group computes;
    UNet3D takes its two decoder forms and ignores the 2D-only fields,
    as the JAX UNet3D does."""
    jmodel, variables, model, x = unet2d
    build = {**BUILD, "predict_skip_bn": True, "predict_fused_bn": True,
             "dilated_upconv": True}
    tm = tinit.build_model(build)
    jm = jinit.build_model(build)
    assert (tm.predict_skip_bn, tm.predict_fused_bn, tm.dilated_upconv) \
        == (jm.predict_skip_bn, jm.predict_fused_bn, jm.dilated_upconv) \
        == (True, True, True)
    tm.load_state_dict(model.state_dict())
    want = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = tm(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=2e-5)
    b3 = {**build, "model_class_name": "UNet3D", "subpixel_decoder": True,
          "lane_pad": 8}
    t3 = tinit.build_model(b3)
    j3 = jinit.build_model(b3)
    assert type(t3) is UNet3D
    assert (t3.subpixel_decoder, t3.dilated_upconv) == \
        (j3.subpixel_decoder, j3.dilated_upconv) == (True, True)
    assert t3.lane_pad == 0 and not t3.predict_skip_bn
    assert not hasattr(j3, "lane_pad")
    assert isinstance(t3.decoder_L0_conv_up, SubpixelUpConv)


def test_glorot_init_treats_up_conv_forms_as_the_conv():
    """glorot_init draws the same kernels for every decoder form (each
    holds the plain 2^n conv's weight), so a seed gives one model."""
    a = glorot_init(UNet(**KW), seed=3, device="cpu").state_dict()
    for form in ("dilated_upconv", "subpixel_decoder"):
        b = glorot_init(UNet(**KW, **{form: True}), seed=3,
                        device="cpu").state_dict()
        assert list(a) == list(b)
        assert all(torch.equal(a[k], b[k]) for k in a)
