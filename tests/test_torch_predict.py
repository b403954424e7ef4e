"""The port's MultiViewPredictor against the JAX package's (shear
resampler), and the oracle reconstruction on the port alone."""
import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from multiplanarunet_tpu.image.volume_sampler import (
    VolumeSampler as JVolumeSampler,
)
from multiplanarunet_tpu.models import checkpoint as jckpt
from multiplanarunet_tpu.models.unet import UNet as JUNet
from multiplanarunet_tpu.ops import geometry as jgeo
from multiplanarunet_tpu.utils.fusion import (
    MultiViewPredictor as JMultiViewPredictor,
)
from multiplanarunet_tpu_torch.image.volume_sampler import VolumeSampler
from multiplanarunet_tpu_torch.models import checkpoint as tckpt
from multiplanarunet_tpu_torch.models.unet import UNet
from multiplanarunet_tpu_torch.utils.fusion.fuse_and_predict import (
    MultiViewPredictor,
    ShearUnsupportedError,
)

torch.set_num_threads(2)

SIZE = 32
N_CLASSES = 3
CPU = torch.device("cpu")


class _Image:
    """Minimal ImagePair stand-in: shape, affine, interpolator."""

    def __init__(self, volume, affine, sampler):
        self.shape = volume.shape
        self.affine = affine
        self.interpolator = sampler


def _rotated_affine():
    R = jgeo.rotation_matrix([0, 0, 1], angle_deg=25) @ \
        jgeo.rotation_matrix([1, 0, 0], angle_deg=10)
    affine = np.eye(4)
    affine[:3, :3] = R
    return affine


@pytest.fixture(scope="module")
def both_predictors(tmp_path_factory):
    """(JAX predictor, port predictor, JAX image, port image) on the same
    small UNet weights, carried through the checkpoint format."""
    kw = dict(n_classes=N_CLASSES, n_channels=1, depth=2, init_filters=8)
    jmodel = JUNet(dim=SIZE, **kw)
    variables = jax.jit(lambda k: jmodel.init(
        k, jnp.zeros((1, SIZE, SIZE, 1)), train=False))(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    # Sharpen the out conv so class decisions are not near-ties
    params = jax.tree.map(np.asarray, variables["params"])
    params["out_conv"]["kernel"] = params["out_conv"]["kernel"] * 8.0
    params["out_conv"]["bias"] = np.zeros(N_CLASSES, np.float32)
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    path = tmp_path_factory.mktemp("w") / "unet.npz"
    jckpt.save_weights(path, params, stats)
    p, s, _ = tckpt.load_weights(path)
    model = UNet(**kw)
    model.load_state_dict(tckpt.unet_state_dict_from_jax(p, s, model))
    model.eval()

    from scipy import ndimage

    vol = ndimage.gaussian_filter(rng.randn(SIZE, SIZE, SIZE), 2.0)
    vol = (vol / vol.std())[..., None].astype(np.float32)
    affine = _rotated_affine()
    jimg = _Image(vol, affine, JVolumeSampler(vol, None, affine, 0.0))
    timg = _Image(vol, affine, VolumeSampler(vol, affine, 0.0))
    assert timg.interpolator.rot_mat is not None  # rotation path active
    jpred = JMultiViewPredictor(
        jmodel, {"params": params, "batch_stats": stats}, sample_dim=SIZE,
        real_space_span=float(SIZE - 1), n_classes=N_CLASSES,
        resampler="shear")
    tpred = MultiViewPredictor(model, sample_dim=SIZE,
                               real_space_span=float(SIZE - 1),
                               n_classes=N_CLASSES, device=CPU)
    return jpred, tpred, jimg, timg


@pytest.mark.parametrize("learned", [False, True])
def test_port_matches_jax_predictor(both_predictors, learned):
    """Same weights, volume, views and fusion through both predictors.
    Both resample in bf16 (JAX's CPU take form multiplies and sums taps in
    bf16, the port sums in f32) and cast the U-Net probabilities to bf16,
    so fused probabilities agree to a few bf16 ulps of 1: atol 3e-2.
    Class maps agree except at near-ties: >= 0.99."""
    jpred, tpred, jimg, timg = both_predictors
    views = jgeo.get_random_views(3, rng=np.random.RandomState(5))
    fp = None
    if learned:
        rngw = np.random.RandomState(7)
        fp = {"fusion": {
            "W": (1.0 + 0.3 * rngw.rand(3, N_CLASSES)).astype(np.float32),
            "b": (0.2 * rngw.randn(1, N_CLASSES)).astype(np.float32)}}
    j_probs, j_pv = jpred.predict_image(jimg, views, fusion_params=fp,
                                        n_planes="same+8", return_probs=True)
    t_probs, t_pv = tpred.predict_image(timg, views, fusion_params=fp,
                                        n_planes="same+8", return_probs=True)
    t_cls, none_pv = tpred.predict_image(timg, views, fusion_params=fp,
                                         n_planes="same+8",
                                         return_per_view=False)
    assert none_pv is None
    assert t_probs.shape == j_probs.shape == (SIZE,) * 3 + (N_CLASSES,)
    assert t_cls.dtype == np.uint8 and t_cls.shape == (SIZE,) * 3
    np.testing.assert_allclose(t_probs, j_probs, atol=3e-2)
    np.testing.assert_array_equal(t_cls, t_probs.argmax(-1))
    assert (t_cls == j_probs.argmax(-1)).mean() >= 0.99
    # the map is not degenerate
    counts = np.bincount(t_cls.ravel(), minlength=N_CLASSES)
    assert counts.max() < 0.9 * t_cls.size
    assert len(t_pv) == len(j_pv) == 3
    for a, b in zip(t_pv, j_pv):
        assert a.dtype == np.uint8
        assert (a == b).mean() >= 0.99


class OneHotOracle(nn.Module):
    """'Model' returning one_hot(round(input intensity)) - ground truth."""

    def __init__(self, n_classes):
        super().__init__()
        self.n_classes = n_classes

    def forward(self, x):
        cls = torch.clamp(torch.round(x[:, 0].float()), 0, self.n_classes - 1)
        onehot = nn.functional.one_hot(cls.long(), self.n_classes)
        return onehot.permute(0, 3, 1, 2).float()


def test_oracle_reconstructs_labels():
    """Feed the label volume as the image through a one-hot oracle: the
    stack -> model -> remap -> fuse pipeline must reconstruct it (as
    tests/test_predict_graph.py holds the JAX shear path to)."""
    size, nc = 24, 4
    lab = np.zeros((size, size, size), np.uint8)
    lab[4:12, 4:12, 4:12] = 1
    lab[14:20, 6:14, 8:16] = 2
    lab[6:10, 14:20, 14:20] = 3
    vol = lab.astype(np.float32)[..., None]
    img = _Image(vol, np.eye(4), VolumeSampler(vol, np.eye(4)))
    pred = MultiViewPredictor(OneHotOracle(nc), sample_dim=size,
                              real_space_span=float(size - 2), n_classes=nc,
                              device=CPU, chunk=4)
    views = jgeo.get_random_views(4, rng=np.random.RandomState(3))
    fused, per_view = pred.predict_image(img, views, n_planes="same+20",
                                         return_probs=True)
    assert fused.shape == lab.shape + (nc,)
    np.testing.assert_allclose(fused.sum(-1), 1.0, atol=1e-2)
    interior = np.zeros_like(lab, bool)
    interior[2:-2, 2:-2, 2:-2] = True
    assert (fused.argmax(-1) == lab)[interior].mean() > 0.95
    for pv in per_view:
        assert (pv == lab)[interior].mean() > 0.91


def test_named_errors():
    with pytest.raises(ValueError, match="divisible"):
        MultiViewPredictor(UNet(n_classes=2, depth=2, init_filters=4),
                           sample_dim=30, real_space_span=30.0, n_classes=2,
                           device=CPU)
    vol = np.zeros((16, 16, 16, 1), np.float32)
    img = _Image(vol, np.eye(4), VolumeSampler(vol, np.eye(4)))
    pred = MultiViewPredictor(OneHotOracle(2), sample_dim=16,
                              real_space_span=15.0, n_classes=2, device=CPU)
    views = jgeo.get_random_views(2, rng=np.random.RandomState(0))
    pred.stage_bytes_max = 1.0  # every plan is over budget
    with pytest.raises(ShearUnsupportedError, match="gather") as err:
        pred.predict_image(img, views)
    assert isinstance(err.value, NotImplementedError)
    assert "channel-grouped" in str(err.value)
