"""The port's last four `mp` scripts against the JAX package's:
trim_channels, convert_weights (Keras .h5 -> .npz), export_weights (.npz
-> Keras .h5) and run_tests, and the `mp` dispatcher's script list."""
import functools
import re
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from multiplanarunet_tpu.bin import convert_weights as j_convert
from multiplanarunet_tpu.bin import export_weights as j_export
from multiplanarunet_tpu.bin import mp as j_mp
from multiplanarunet_tpu.bin import trim_channels as j_trim
from multiplanarunet_tpu.models import UNet as JUNet
from multiplanarunet_tpu.models import UNet3D as JUNet3D
from multiplanarunet_tpu.models import checkpoint as jckpt
from multiplanarunet_tpu_torch.bin import convert_weights as t_convert
from multiplanarunet_tpu_torch.bin import export_weights as t_export
from multiplanarunet_tpu_torch.bin import mp as t_mp
from multiplanarunet_tpu_torch.bin import run_tests as t_run_tests
from multiplanarunet_tpu_torch.io import nifti
from multiplanarunet_tpu_torch.models import checkpoint as tckpt
from multiplanarunet_tpu_torch.models.unet import UNet
from multiplanarunet_tpu_torch.models.unet3d import UNet3D
from tests.torch_projects import flax_init, torch_threads  # noqa: F401

h5py = pytest.importorskip("h5py")


# ------------------------------------------------------------ dispatcher
def test_get_scripts_equals_the_jax_list():
    assert t_mp.get_scripts() == j_mp.get_scripts()
    assert len(t_mp.get_scripts()) == 15
    parser = t_mp.get_parser()
    for script in t_mp.get_scripts():
        assert parser.parse_args([script, "--x"]).script == script
    with pytest.raises(SystemExit) as e:
        parser.parse_args(["mp"])
    assert e.value.code == 2


# --------------------------------------------------------- trim_channels
def test_trim_channels_equals_jax(tmp_path, capsys):
    rng = np.random.RandomState(0)
    affine = np.diag([1.0, 1.2, 0.8, 1.0])
    vols = {"four_d.nii.gz": rng.rand(6, 5, 4, 3).astype(np.float32),
            "int_ch.nii": rng.randint(0, 9, (5, 5, 3, 3)).astype(np.int16),
            "three_d.nii.gz": rng.rand(4, 4, 4).astype(np.float32)}
    for pkg in ("t", "j"):
        (tmp_path / pkg).mkdir()
        for name, vol in vols.items():
            nifti.save(vol, tmp_path / pkg / name, affine)
    t_mp.entry_func(["trim_channels", "--folder", str(tmp_path / "t"),
                     "--channels", "0,2"])
    t_out = capsys.readouterr().out
    j_trim.entry_func(["--folder", str(tmp_path / "j"), "--channels", "0,2"])
    j_out = capsys.readouterr().out
    assert t_out.replace("/t/", "/j/") == j_out
    for name in vols:
        t_bytes = (tmp_path / "t" / name).read_bytes()
        assert t_bytes == (tmp_path / "j" / name).read_bytes(), name
    got = nifti.load(tmp_path / "t" / "four_d.nii.gz")
    np.testing.assert_array_equal(got.get_raw_data(),
                                  vols["four_d.nii.gz"][..., [0, 2]])
    np.testing.assert_allclose(got.affine, affine, rtol=1e-6)  # float32 sform
    # one kept channel drops the channel axis
    t_mp.entry_func(["trim_channels", "--folder", str(tmp_path / "t"),
                     "--channels", "1"])
    np.testing.assert_array_equal(
        nifti.load(tmp_path / "t" / "int_ch.nii").get_raw_data(),
        vols["int_ch.nii"][..., 2])


# ------------------- Keras .h5 writers (copied from test_convert_weights)
def _ref_name_2d(path):
    """Our param module path -> reference Keras layer name."""
    m = re.match(r"^encoder_L(\d+)/conv(\d)$", path)
    if m:
        return f"encoder_L{m.group(1)}_conv{m.group(2)}"
    m = re.match(r"^encoder_L(\d+)/bn$", path)
    if m:
        return f"encoder_L{m.group(1)}_BN"
    m = re.match(r"^bottom/conv(\d)$", path)
    if m:
        return f"bottom_conv{m.group(1)}"
    if path == "bottom/bn":
        return "bottom_BN"
    m = re.match(r"^decoder_L(\d+)_conv_up$", path)
    if m:
        return f"upsample_L{m.group(1)}_conv1"
    m = re.match(r"^decoder_L(\d+)_bn_up$", path)
    if m:
        return f"upsample_L{m.group(1)}_BN1"
    m = re.match(r"^decoder_L(\d+)/conv(\d)$", path)
    if m:
        return f"upsample_L{m.group(1)}_conv{int(m.group(2)) + 1}"
    m = re.match(r"^decoder_L(\d+)/bn$", path)
    if m:
        return f"upsample_L{m.group(1)}_BN2"
    if path == "out_conv":
        return "conv2d_17"
    raise AssertionError(path)


_LEAF_TO_KERAS = {("params", "kernel"): "kernel:0",
                  ("params", "bias"): "bias:0",
                  ("params", "scale"): "gamma:0",
                  ("batch_stats", "mean"): "moving_mean:0",
                  ("batch_stats", "var"): "moving_variance:0"}


def _keras_leaf(coll, module, leaf):
    if coll == "params" and leaf == "bias" and module.endswith(("bn",
                                                                "bn_up")):
        return "beta:0"
    return _LEAF_TO_KERAS[(coll, leaf)]


def _write_h5(path, variables, name_of, full_save=False):
    """A Keras-weights-style h5 of randomized arrays shaped like
    `variables` (under model_weights/ for a full model save)."""
    rng = np.random.RandomState(0)
    with h5py.File(path, "w") as f:
        root = f.create_group("model_weights") if full_save else f
        for coll in ("params", "batch_stats"):
            flat = traverse_util.flatten_dict(variables.get(coll, {}),
                                              sep="/")
            for k, v in flat.items():
                module, leaf = k.rsplit("/", 1)
                layer = name_of(module)
                arr = rng.randn(*np.shape(v)).astype(np.float32)
                grp = root.require_group(layer).require_group(layer)
                grp.create_dataset(_keras_leaf(coll, module, leaf), data=arr)


@functools.lru_cache(maxsize=None)
def _variables(three_d):
    """A flax UNet (UNet3D) of depth 2 and its init variables (as the JAX
    package's init_model_variables draws them)."""
    cls = JUNet3D if three_d else JUNet
    model = cls(n_classes=3, dim=16 if three_d else 32, depth=2,
                init_filters=8, complexity_factor=1)
    shape = (1,) + (model.dim,) * (3 if three_d else 2) + (model.n_channels,)
    return model, flax_init(model, jax.random.PRNGKey(0), shape)


def _autonamed_3d(depth=2):
    conv_order, bn_order = j_convert._ordered_targets(
        2 * depth + 2 + 3 * depth + 1, 2 * depth + depth + 1)
    conv_names = ["conv3d"] + [f"conv3d_{i}"
                               for i in range(1, len(conv_order))]
    bn_names = ["batch_normalization"] + [
        f"batch_normalization_{i}" for i in range(1, len(bn_order))]
    return {**dict(zip(conv_order, conv_names)),
            **dict(zip(bn_order, bn_names))}.__getitem__


def _npz_entries(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


@pytest.mark.parametrize("case", ["named_2d", "named_2d_full_save",
                                  "autonamed_3d"])
def test_convert_weights_npz_equals_jax(tmp_path, case, capsys):
    three_d = case == "autonamed_3d"
    _, variables = _variables(three_d)
    h5 = tmp_path / "model_weights.h5"
    _write_h5(h5, variables, _autonamed_3d() if three_d else _ref_name_2d,
              full_save=case.endswith("full_save"))
    t_mp.entry_func(["convert_weights", "--h5", str(h5), "--out",
                     str(tmp_path / "t.npz")])
    t_out = capsys.readouterr().out
    j_convert.entry_func(["--h5", str(h5), "--out", str(tmp_path / "j.npz")])
    j_out = capsys.readouterr().out
    assert t_out.replace("t.npz", "j.npz") == j_out
    t_entries, j_entries = (_npz_entries(tmp_path / f"{p}.npz")
                            for p in "tj")
    assert list(t_entries) == list(j_entries)
    for k in j_entries:
        assert t_entries[k].dtype == j_entries[k].dtype, k
        np.testing.assert_array_equal(t_entries[k], j_entries[k])
    # the default output path sits beside the h5
    t_convert.entry_func(["--h5", str(h5)])
    assert (tmp_path / "model_weights.npz").exists()


def _h5_contents(path):
    """(root attrs, {group: attrs}, {dataset: array}) of an h5 file."""
    groups, datasets = {}, {}
    with h5py.File(path, "r") as f:
        root_attrs = {k: np.asarray(v).tolist() for k, v in f.attrs.items()}

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                datasets[name] = (np.asarray(obj), obj.dtype)
            else:
                groups[name] = {k: np.asarray(v).tolist()
                                for k, v in obj.attrs.items()}

        f.visititems(visit)
        order = list(f.keys())
    return root_attrs, groups, datasets, order


@pytest.mark.parametrize("three_d", [False, True])
def test_export_weights_h5_equals_jax(tmp_path, three_d, capsys):
    _, variables = _variables(three_d)
    npz = tmp_path / "w.npz"
    jckpt.save_weights(npz, variables["params"], variables["batch_stats"])
    t_mp.entry_func(["export_weights", "--weights", str(npz), "--out",
                     str(tmp_path / "t.h5")])
    t_out = capsys.readouterr().out
    j_export.entry_func(["--weights", str(npz), "--out",
                         str(tmp_path / "j.h5")])
    assert t_out.replace("t.h5", "j.h5") == capsys.readouterr().out
    t_attrs, t_groups, t_data, t_order = _h5_contents(tmp_path / "t.h5")
    j_attrs, j_groups, j_data, j_order = _h5_contents(tmp_path / "j.h5")
    assert t_attrs == j_attrs and t_groups == j_groups
    assert t_order == j_order
    assert list(t_data) == list(j_data)
    for k, (arr, dtype) in j_data.items():
        assert t_data[k][1] == dtype
        np.testing.assert_array_equal(t_data[k][0], arr)
    layer_names = [n.decode() if isinstance(n, bytes) else n
                   for n in t_attrs["layer_names"]]
    assert layer_names[0] == ("conv3d" if three_d else "encoder_L0_conv1")


@pytest.mark.parametrize("three_d", [False, True])
def test_round_trip_gives_the_jax_probabilities(tmp_path, three_d):
    """The port's export -> convert of JAX-format weights, loaded into
    the port's model: the flax model's eval probabilities within 1e-5."""
    model, variables = _variables(three_d)
    rng = np.random.RandomState(2)
    # BatchNorm statistics away from their init values
    stats = jax.tree.map(lambda s: np.asarray(s) + 0.1 * rng.rand(
        *s.shape).astype(np.float32), variables["batch_stats"])
    npz = tmp_path / "w.npz"
    jckpt.save_weights(npz, variables["params"], stats)
    t_export.entry_func(["--weights", str(npz), "--out",
                         str(tmp_path / "w.h5")])
    t_convert.entry_func(["--h5", str(tmp_path / "w.h5"), "--out",
                          str(tmp_path / "w2.npz")])
    params, batch_stats, meta = tckpt.load_weights(tmp_path / "w2.npz")
    assert meta == {"converted_from": str(tmp_path / "w.h5")}
    kw = dict(n_classes=3, n_channels=1, depth=2, init_filters=8)
    port = (UNet3D if three_d else UNet)(**kw)
    port.load_state_dict(tckpt.unet_state_dict_from_jax(params, batch_stats,
                                                        port))
    port.eval()
    shape = (2,) + ((16,) * 3 if three_d else (32, 32)) + (1,)
    x = rng.rand(*shape).astype(np.float32)
    want = np.asarray(model.apply({"params": variables["params"],
                                   "batch_stats": stats},
                                  jnp.asarray(x), train=False))
    with torch.no_grad():
        got = port(torch.from_numpy(x).movedim(-1, 1)).movedim(1, -1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_weight_scripts_name_h5py_without_it(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        t_mp.entry_func(["convert_weights", "--h5", str(tmp_path / "a.h5")])
    _, variables = _variables(False)
    npz = tmp_path / "w.npz"
    jckpt.save_weights(npz, variables["params"], variables["batch_stats"])
    with pytest.raises(ImportError, match="h5py"):
        t_mp.entry_func(["export_weights", "--weights", str(npz)])
    assert not (tmp_path / "w.h5").exists()


# ------------------------------------------------------------- run_tests
def test_run_tests_builds_pytest_arguments(monkeypatch):
    import pytest as pytest_module

    calls = []
    monkeypatch.setattr(pytest_module, "main",
                        lambda args: calls.append(args) or 0)
    with pytest.raises(SystemExit) as e:
        t_mp.entry_func(["run_tests"])
    assert e.value.code == 0
    with pytest.raises(SystemExit):
        t_run_tests.entry_func(["--tests", "scaling and quantile"])
    everything, filtered = calls
    assert everything[0] == "-q"
    files = everything[1:]
    assert files and all(re.search(r"tests/test_torch_\w+\.py$", f)
                         for f in files)
    assert any(f.endswith("test_torch_tools.py") for f in files)
    assert filtered == everything + ["-k", "scaling and quantile"]
