"""The port's small modules and public helpers, each against its JAX
function on the same inputs: conv arithmetic, the type-check decorator,
input shaping, class_wise_kappa and pred_to_class, the utils helpers,
YAMLHParams.delete_group / .log, predict_volume and map_real_space_pred,
the models' receptive_field and count_params, and utils/system over
torch.cuda."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multiplanarunet_tpu.evaluate import metrics as j_metrics
from multiplanarunet_tpu.hyperparameters.hparams import (
    YAMLHParams as JHParams,
)
from multiplanarunet_tpu.models.multitask_unet import (
    MultiTaskUNet2D as JMultiTask,
)
from multiplanarunet_tpu.models.unet import UNet as JUNet
from multiplanarunet_tpu.models.unet3d import UNet3D as JUNet3D
from multiplanarunet_tpu.preprocessing import input_prep as j_input_prep
from multiplanarunet_tpu.utils import conv_arithmetics as j_conv
from multiplanarunet_tpu.utils import decorators as j_decorators
from multiplanarunet_tpu.utils import utils as j_utils
from multiplanarunet_tpu.utils.fusion import fuse_and_predict as j_fuse
from multiplanarunet_tpu_torch.evaluate import metrics as t_metrics
from multiplanarunet_tpu_torch.hyperparameters.hparams import (
    YAMLHParams as THParams,
)
from multiplanarunet_tpu_torch.models.multitask_unet import MultiTaskUNet2D
from multiplanarunet_tpu_torch.models.unet import UNet
from multiplanarunet_tpu_torch.models.unet3d import UNet3D
from multiplanarunet_tpu_torch.preprocessing import input_prep as t_input_prep
from multiplanarunet_tpu_torch.utils import conv_arithmetics as t_conv
from multiplanarunet_tpu_torch.utils import decorators as t_decorators
from multiplanarunet_tpu_torch.utils import system as t_system
from multiplanarunet_tpu_torch.utils import utils as t_utils
from multiplanarunet_tpu_torch.utils.fusion import fuse_and_predict as t_fuse
from tests.torch_projects import torch_threads  # noqa: F401


@pytest.mark.parametrize("depth,k,dim,cf,nc,ch", [
    (4, 3, 256, 2.0, 7, 1), (2, 5, 64, 1.0, 3, 2), (3, 3, 96, 0.5, 4, 1)])
def test_conv_arithmetics(depth, k, dim, cf, nc, ch):
    layers = [(k, 1), (k, 2), (2, 2), (k, 1)]
    assert t_conv.receptive_field(layers) == j_conv.receptive_field(layers)
    assert t_conv.unet_encoder_receptive_field(depth, k) == \
        j_conv.unet_encoder_receptive_field(depth, k)
    assert t_conv.unet_forward_flops(dim, nc, ch, depth, 64, cf, k) == \
        j_conv.unet_forward_flops(dim, nc, ch, depth, 64, cf, k)
    t_model = UNet(n_classes=nc, n_channels=ch, depth=depth,
                   complexity_factor=cf, kernel_size=k)
    j_model = JUNet(n_classes=nc, n_channels=ch, depth=depth,
                    complexity_factor=cf, kernel_size=k)
    assert t_model.receptive_field == j_model.receptive_field


def _flax_params(model, shape):
    return jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                             jnp.zeros(shape),
                                             train=False))["params"]


@pytest.mark.parametrize("kind", ["2d", "3d", "multitask"])
def test_count_params_matches_flax(kind):
    if kind == "2d":
        t = UNet(n_classes=5, n_channels=2, depth=3, complexity_factor=0.5,
                 init_filters=8)
        j = JUNet(n_classes=5, n_channels=2, depth=3, complexity_factor=0.5,
                  init_filters=8)
        params = _flax_params(j, (1, 32, 32, 2))
    elif kind == "3d":
        t = UNet3D(n_classes=3, depth=2, init_filters=4)
        j = JUNet3D(n_classes=3, depth=2, init_filters=4)
        params = _flax_params(j, (1, 16, 16, 16, 1))
    else:
        kw = dict(task_names=("a", "b"), n_classes=(3, 4), n_channels=(1, 1),
                  dim=(16, 16), depth=2, init_filters=4)
        t, j = MultiTaskUNet2D(**kw), JMultiTask(**kw)
        params = jax.eval_shape(lambda: j.init(
            jax.random.PRNGKey(0), (jnp.zeros((1, 16, 16, 1)),) * 2,
            train=False))["params"]
    assert t.count_params() == j.count_params(params)


def test_accepts_decorator():
    for mod in (t_decorators, j_decorators):
        class Box:
            @mod.accepts(int, str)
            def set(self, a, b):
                return a, b

        assert Box().set(1, "x") == (1, "x")
        with pytest.raises(TypeError, match="expected"):
            Box().set("1", "x")

        @mod.accepts(float)
        def half(x):
            return x / 2

        assert half(3.0) == 1.5
        with pytest.raises(TypeError):
            half(3)


def test_input_prep():
    rng = np.random.RandomState(0)
    for shape, dims in (((5, 6), 2), ((5, 6, 2), 2), ((1, 5, 6, 2), 2),
                        ((4, 4, 4), 3)):
        x = rng.rand(*shape)
        np.testing.assert_array_equal(t_input_prep.reshape_add_axis(x, dims),
                                      j_input_prep.reshape_add_axis(x, dims))
    y = rng.randint(0, 4, (3, 5))
    got = t_input_prep.one_hot_encode_y(y, 4)
    np.testing.assert_array_equal(got, j_input_prep.one_hot_encode_y(y, 4))
    assert got.dtype == np.float32


@pytest.mark.filterwarnings("ignore::UserWarning")
@pytest.mark.parametrize("case", ["random", "perfect", "absent", "all_one"])
def test_class_wise_kappa_matches_sklearn(case):
    rng = np.random.RandomState(1)
    true = rng.randint(0, 4, (6, 7, 5))
    pred = np.where(rng.rand(*true.shape) < 0.7, true,
                    rng.randint(0, 4, true.shape))
    if case == "perfect":
        pred = true.copy()
    elif case == "absent":
        true[true == 3] = 1
        pred[pred == 3] = 2
    elif case == "all_one":  # one label in common: sklearn's NaN
        true[:] = 2
        pred[:] = 2
    for n_classes in (None, 4, 6):
        for ignore in (True, False):
            np.testing.assert_allclose(
                t_metrics.class_wise_kappa(true, pred, n_classes, ignore),
                j_metrics.class_wise_kappa(true, pred, n_classes, ignore),
                rtol=1e-6, atol=1e-7)


def test_pred_to_class_both_modules():
    rng = np.random.RandomState(2)
    probs = rng.rand(4, 5, 6, 3)
    binary = rng.rand(4, 5, 6, 1)
    for x in (probs, binary):
        np.testing.assert_array_equal(t_metrics.pred_to_class(x),
                                      j_metrics.pred_to_class(x))
        for kw in ({}, {"img_dims": 2, "has_batch_dim": True},
                   {"img_dims": 4}, {"threshold": 0.3}):
            np.testing.assert_array_equal(t_utils.pred_to_class(x, **kw),
                                          j_utils.pred_to_class(x, **kw))


def test_utils_helpers(tmp_path):
    for s in ("one line", "a\nlonger second line", ""):
        assert t_utils.highlighted(s) == j_utils.highlighted(s)
    csv = tmp_path / "training.csv"
    assert t_utils.get_last_epoch(csv) == j_utils.get_last_epoch(csv) == 0
    csv.write_text("epoch,loss\n")
    assert t_utils.get_last_epoch(csv) == j_utils.get_last_epoch(csv) == 0
    csv.write_text("epoch,loss\n0,1.0\n1,0.5\n4.0,0.2\n\n")
    assert t_utils.get_last_epoch(csv) == j_utils.get_last_epoch(csv) == 4
    for fractions in ((0.5, 0.5), (0.2, 0.3, 0.5), (1.0,)):
        np.random.seed(3)
        got = t_utils.random_split(17, fractions)
        np.random.seed(3)
        want = j_utils.random_split(17, fractions)
        assert [g.tolist() for g in got] == [w.tolist() for w in want]
        got = t_utils.random_split(9, fractions, np.random.RandomState(4))
        want = j_utils.random_split(9, fractions, np.random.RandomState(4))
        assert [g.tolist() for g in got] == [w.tolist() for w in want]


YAML = """\
# a comment
build:
  n_classes: 3
  dim: 16

fit:
  batch_size: 4
  views: [[1, 0, 0], [0, 1, 0]]

extra_group:
  a: 1
  b: [1, 2]
"""


def test_hparams_delete_group_and_log(tmp_path):
    class Rec(list):
        def __call__(self, *args, **kwargs):
            self.append(" ".join(str(a) for a in args))

        warn = __call__

    out = {}
    for name, cls in (("t", THParams), ("j", JHParams)):
        path = tmp_path / f"{name}.yaml"
        path.write_text(YAML)
        rec = Rec()
        hp = cls(path, logger=rec, no_log=True, no_version_control=True)
        rec.clear()
        hp.delete_group("extra_group")
        hp.log()
        out[name] = (hp.string_rep, dict(hp), list(rec))
        with pytest.raises(KeyError):
            hp.delete_group("no_such_group")
    assert out["t"] == out["j"]
    assert "extra_group" not in out["t"][0] and "extra_group" not in out["t"][1]


def test_predict_volume_matches_jax():
    rng = np.random.RandomState(5)
    X = rng.rand(6, 5, 7, 2).astype(np.float32)
    W = rng.rand(2, 3).astype(np.float32)
    for axis in (0, 2):
        got = t_fuse.predict_volume(lambda x: x @ torch.from_numpy(W),
                                    torch.from_numpy(X), batch_size=3,
                                    axis=axis)
        want = j_fuse.predict_volume(lambda x: x @ W, X, batch_size=3,
                                     axis=axis)
        assert isinstance(got, torch.Tensor)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6)


def _rotation(seed):
    q, r = np.linalg.qr(np.random.RandomState(seed).randn(3, 3))
    return q * np.sign(np.diag(r))


@pytest.mark.parametrize("seed", [0, 1])
def test_map_real_space_pred_matches_jax(seed):
    """The nearest remap of a (d, d, P, C) stack onto a voxel grid: equal
    to the JAX package's but for rare nearest ties (the frameworks' float32
    coordinates may round a tie differently)."""
    rng = np.random.RandomState(seed)
    d, P, C = 12, 9, 3
    pred = rng.rand(d, d, P, C).astype(np.float32)
    real_axis = np.linspace(-7.0, 7.0, d)
    offsets = np.linspace(-5.0, 5.0, P)
    affine = np.diag([1.1, 0.9, 1.0, 1.0])
    shape = (10, 11, 9)
    inv_basis = _rotation(seed)
    want = j_fuse.map_real_space_pred(pred, (real_axis, real_axis, offsets),
                                      inv_basis, affine, shape)
    got = t_fuse.map_real_space_pred(torch.from_numpy(pred),
                                     (real_axis, real_axis, offsets),
                                     inv_basis, affine, shape)
    assert isinstance(got, torch.Tensor) and got.shape == shape + (C,)
    same = np.all(got.numpy() == want, axis=-1)
    assert same.mean() >= 0.999, same.mean()
    # out-of-bounds voxels carry the one-hot background in both
    assert (np.asarray(want)[..., 0] == 1).any()


# ------------------------------------------------------------ utils/system
def test_system_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert t_system.get_devices() == []
    assert t_system.describe_devices() == ""
    assert t_system.device_memory_stats() == {}
    lines = []
    monitor = t_system.DeviceMonitor(logger=lines.append, interval_s=0.01)
    monitor._stop.wait(0.05)
    monitor.stop()
    assert lines == [] and monitor.samples == []
    assert monitor.await_and_set_free_devices(2) == []
    assert t_system.host_rss_gib() > 0 and t_system.host_core_count() >= 1


def test_system_over_torch_cuda(monkeypatch):
    """The device list, stats and monitor read torch.cuda (here a stand-in
    for one card: no card is on this host)."""
    allocated = [1000]
    fake = {"is_available": lambda: True, "device_count": lambda: 1,
            "get_device_name": lambda d=None: "Stand-in card",
            "memory_allocated": lambda d=None: allocated[0],
            "max_memory_allocated": lambda d=None: 4096,
            "memory_reserved": lambda d=None: 8192,
            "get_device_properties": lambda d=None: type(
                "P", (), {"total_memory": 2 ** 30})}
    for name, fn in fake.items():
        monkeypatch.setattr(torch.cuda, name, fn)
    assert t_system.get_devices() == [torch.device("cuda", 0)]
    assert t_system.describe_devices() == "[0] cuda Stand-in card"
    assert t_system.device_memory_stats() == {0: {
        "bytes_in_use": 1000, "peak_bytes_in_use": 4096,
        "bytes_reserved": 8192, "bytes_limit": 2 ** 30}}
    lines = []
    monitor = t_system.DeviceMonitor(logger=lines.append, interval_s=0.01)
    for _ in range(500):
        if monitor.samples:
            break
        monitor._stop.wait(0.01)
    allocated[0] = 5 * 2 ** 30
    monitor.stop()
    assert monitor.samples and monitor.samples[0][1:] == (0, 1000)
    assert lines[0] == "[DeviceMonitor] dev 0: 0.00 GiB in use (1000 bytes)"
    assert monitor.free_GPUs == [0]
    assert monitor.await_and_set_free_GPU(1) == [0]
