"""The port's UNet and fusion model against the flax originals, on the same
weights carried through the JAX package's checkpoint format."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multiplanarunet_tpu.models import checkpoint as jckpt
from multiplanarunet_tpu.models.fusion_model import FusionModel as JFusion
from multiplanarunet_tpu.models.fusion_model import (
    fuse_probabilities as j_fuse,
)
from multiplanarunet_tpu.models.unet import UNet as JUNet
from multiplanarunet_tpu_torch.models import checkpoint as tckpt
from multiplanarunet_tpu_torch.models.fusion_model import FusionModel
from multiplanarunet_tpu_torch.models.fusion_model import fuse_probabilities
from multiplanarunet_tpu_torch.models.unet import UNet

torch.set_num_threads(2)


def init_unet(model, key, shape):
    """(params, batch_stats) of a flax UNet (jitted: eager init is slow)."""
    v = jax.jit(lambda k: model.init(k, jnp.zeros(shape), train=False))(key)
    return v["params"], v["batch_stats"]


def _perturbed_variables(model, seed, hw):
    """flax variables with random (not init-default) BN statistics, so the
    mapping of every BN leaf is exercised."""
    params, stats = init_unet(model, jax.random.PRNGKey(seed),
                              (1, hw, hw, model.n_channels))
    rng = np.random.RandomState(seed)
    params = jax.tree.map(
        lambda p: np.asarray(p) + 0.05 * rng.randn(*p.shape).astype(
            np.float32), params)
    stats = jax.tree.map(lambda s: np.asarray(s), stats)
    for mod in stats.values():
        for leaf in mod.values() if "mean" not in mod else [mod]:
            leaf["mean"] = 0.1 * rng.randn(*leaf["mean"].shape).astype(
                np.float32)
            leaf["var"] = (0.5 + rng.rand(*leaf["var"].shape)).astype(
                np.float32)
    return params, stats


def _port_model(params, stats, path, **kw):
    jckpt.save_weights(path, params, stats, meta={"note": "test"})
    p, s, meta = tckpt.load_weights(path)
    assert meta == {"note": "test"}
    model = UNet(**kw)
    model.load_state_dict(tckpt.unet_state_dict_from_jax(p, s, model))
    return model.eval()


@pytest.mark.parametrize("cf,hw,depth", [(1.0, 32, 2), (2.0, 30, 2)])
def test_unet_matches_flax(tmp_path, cf, hw, depth):
    """cf=2 gives the non-multiple-of-8 ladder int(8*2^i*sqrt(2)) =
    11, 22, 45; hw=30 pools to 15 and 7, so both decoder levels crop their
    skip (crop_to_match). f32 on both sides: softmax within 1e-5."""
    kw = dict(n_classes=3, n_channels=2, depth=depth, complexity_factor=cf,
              init_filters=8)
    jmodel = JUNet(dim=hw, **kw)
    params, stats = _perturbed_variables(jmodel, 0, hw)
    model = _port_model(params, stats, tmp_path / "w.npz", **kw)
    x = np.random.RandomState(1).randn(3, hw, hw, 2).astype(np.float32)
    apply = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))
    want = np.asarray(apply({"params": params, "batch_stats": stats}, x))
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_unet_bf16_compute_close_to_f32(tmp_path):
    """bf16 convolutions (the card's compute dtype) with f32 parameters,
    BN statistics and out conv stay close to the f32 model: probabilities
    within 0.05 and the argmax mostly agreeing (bf16 keeps 8 bits)."""
    kw = dict(n_classes=3, n_channels=1, depth=2, init_filters=8)
    jmodel = JUNet(dim=16, **kw)
    params, stats = _perturbed_variables(jmodel, 2, 16)
    f32 = _port_model(params, stats, tmp_path / "w.npz", **kw)
    bf16 = _port_model(params, stats, tmp_path / "w.npz",
                       dtype=torch.bfloat16, **kw)
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 1, 16, 16)
                         .astype(np.float32))
    with torch.no_grad():
        a, b = f32(x), bf16(x)
    assert b.dtype == torch.float32
    assert (a - b).abs().max() < 0.05
    assert (a.argmax(1) == b.argmax(1)).float().mean() > 0.95


def test_state_dict_mapping_raises_on_bad_trees(tmp_path):
    kw = dict(n_classes=3, n_channels=1, depth=2, init_filters=8)
    params, stats = init_unet(JUNet(dim=16, **kw), jax.random.PRNGKey(0),
                              (1, 16, 16, 1))
    jckpt.save_weights(tmp_path / "w.npz", params, stats)
    p, s, _ = tckpt.load_weights(tmp_path / "w.npz")
    model = UNet(**kw)
    del p["bottom"]["conv2"]["kernel"]
    with pytest.raises(KeyError, match="bottom/conv2/kernel"):
        tckpt.unet_state_dict_from_jax(p, s, model)
    p, s, _ = tckpt.load_weights(tmp_path / "w.npz")
    p["out_conv"]["bias"] = np.zeros(5, np.float32)
    with pytest.raises(ValueError, match="out_conv/bias"):
        tckpt.unet_state_dict_from_jax(p, s, model)
    p, s, _ = tckpt.load_weights(tmp_path / "w.npz")
    p["extra"] = {"kernel": np.zeros(1, np.float32)}
    with pytest.raises(KeyError, match="no place"):
        tckpt.unet_state_dict_from_jax(p, s, model)
    # a deeper model than the checkpoint
    p, s, _ = tckpt.load_weights(tmp_path / "w.npz")
    with pytest.raises(KeyError, match="missing"):
        tckpt.unet_state_dict_from_jax(p, s, UNet(**{**kw, "depth": 3}))


def test_fusion_model_matches_flax():
    rng = np.random.RandomState(4)
    V, C = 4, 5
    W = (1.0 + 0.3 * rng.randn(V, C)).astype(np.float32)
    b = (0.2 * rng.randn(1, C)).astype(np.float32)
    x = rng.rand(7, 3, V, C).astype(np.float32)
    params = {"fusion": {"W": W, "b": b}}
    want = np.asarray(JFusion(V, C).apply({"params": params},
                                          jnp.asarray(x)))
    np.testing.assert_allclose(np.asarray(j_fuse(params, jnp.asarray(x))),
                               want, atol=1e-6)
    got = fuse_probabilities(params, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    model = FusionModel(V, C)
    with torch.no_grad():
        model.W.copy_(torch.from_numpy(W))
        model.b.copy_(torch.from_numpy(b))
        np.testing.assert_allclose(model(torch.from_numpy(x)).numpy(), want,
                                   atol=1e-6)
    # init: W ones, b zeros, as the flax module initialises
    init = JFusion(V, C).init_params()
    np.testing.assert_array_equal(np.asarray(init["fusion"]["W"]),
                                  FusionModel(V, C).W.detach().numpy())
    np.testing.assert_array_equal(np.asarray(init["fusion"]["b"]),
                                  FusionModel(V, C).b.detach().numpy())
