"""What the port's test modules share: the torch thread policy, toy data,
a preset's project YAML, an entry point run in place, and both packages'
`mp train` on one toy project, once per process for each configuration.

A port test module takes the thread policy by importing the fixture:

    from tests.torch_projects import torch_threads  # noqa: F401
"""
import atexit
import functools
import os
import shutil
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PRESETS = REPO / "multiplanarunet_tpu" / "bin" / "defaults"
# Intra-op threads of a port test module. The suite runs 6 xdist workers
# on an 8-core host beside JAX's own thread pools: the whole suite took
# 1061 s at 2 and ran past its 1470 s limit at torch's default of one a
# core
TORCH_THREADS = 2
# Both packages' `mp train` over a fresh project, two epochs
ARGS = ("--overwrite", "--epochs", "2")


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """TORCH_THREADS for the module's tests; the count before it is put
    back after the module, so no other module runs under it."""
    before = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(before)


def train_args(n_train, n_val, images=False):
    """ARGS with n_train / n_val images an epoch; --no_images unless
    images."""
    return ARGS + ("--train_images_per_epoch", str(n_train),
                   "--val_images_per_epoch", str(n_val)) + (
        () if images else ("--no_images",))


@functools.cache
def _jitted_init(module, shape):
    import jax
    import jax.numpy as jnp

    def zeros(s):
        return (tuple(map(zeros, s)) if isinstance(s[0], tuple)
                else jnp.zeros(s))

    # XLA's backend optimisation of an init (the threefry draws of every
    # kernel) takes ~10 s a small U-Net on the CPU; at level 0 the compile
    # takes ~1 s and draws the same bits
    return jax.jit(lambda k: module.init(k, zeros(shape), train=False),
                   compiler_options={"xla_backend_optimization_level": 0})


def flax_init(module, key, shape):
    """module.init(key, zeros(shape), train=False), jitted: one compile per
    process for each (module, shape), whatever the key. A tuple of shapes
    passes a tuple of inputs (the multi-task model's)."""
    return _jitted_init(module, tuple(shape))(key)


def preset_yaml(preset):
    """The JAX package's train_hparams.yaml of `preset` (byte-equal to the
    port's copy)."""
    return PRESETS / preset / "train_hparams.yaml"


def toy_data(root, n_train, n_val, dim, seed):
    """root/train and root/val: the JAX package's toy subjects of side dim,
    one channel, drawn in that order from RandomState(seed)."""
    from multiplanarunet_tpu.bin.toy_data import create_dataset

    rng = np.random.RandomState(seed)
    create_dataset(Path(root) / "train", n_train, dim, 1, rng, "train")
    create_dataset(Path(root) / "val", n_val, dim, 1, rng, "val")
    return Path(root)


def write_project(root, name, preset, replacements=()):
    """root/name/train_hparams.yaml: the preset's YAML with its train, val
    and test data at root/data/train, val and val, then each (old, new) of
    replacements made; every old text must be there."""
    root = Path(root)
    proj = root / name
    proj.mkdir()
    hparams = proj / "train_hparams.yaml"
    shutil.copyfile(preset_yaml(preset), hparams)
    edit_yaml(hparams, (
        ("train_data: &TRAINDATA\n  base_dir: Null",
         f"train_data: &TRAINDATA\n  base_dir: {root / 'data' / 'train'}"),
        ("val_data: &VALDATA\n  base_dir: Null",
         f"val_data: &VALDATA\n  base_dir: {root / 'data' / 'val'}"),
        ("test_data: &TESTDATA\n  base_dir: Null",
         f"test_data: &TESTDATA\n  base_dir: {root / 'data' / 'val'}"),
        *replacements))
    return proj


def edit_yaml(path, replacements):
    """Make each (old, new) of replacements, in order, in the text of the
    file at path; every old text must be there."""
    text = Path(path).read_text()
    for old, new in replacements:
        assert old in text, old
        text = text.replace(old, new)
    Path(path).write_text(text)


def run_entry(entry, *args):
    """entry(list(args)), the working directory restored after it."""
    cwd = os.getcwd()
    try:
        return entry(list(args))
    finally:
        os.chdir(cwd)


def _remove_later(path):
    atexit.register(shutil.rmtree, path, ignore_errors=True)
    return path


@functools.cache
def _jax_cache_dir():
    return _remove_later(tempfile.mkdtemp(prefix="mp_jax_cache_"))


_JAX_CACHE_SETTINGS = ("jax_compilation_cache_dir",
                       "jax_persistent_cache_min_entry_size_bytes",
                       "jax_persistent_cache_min_compile_time_secs")


def run_jax_entry(entry, *args):
    """run_entry for a JAX package script, as its `mp` dispatcher runs one:
    with the package's persistent compilation cache on
    (`utils/compilation_cache.py`), here in a directory of this process's
    own, so a program that one script (or an earlier call) compiled is
    not compiled again. The settings before it are put back after, so no
    other code in the process compiles through the cache."""
    import jax
    from jax.experimental.compilation_cache import compilation_cache

    from multiplanarunet_tpu.utils.compilation_cache import (
        enable_compilation_cache,
    )

    before = {name: getattr(jax.config, name) for name in _JAX_CACHE_SETTINGS}
    compilation_cache.reset_cache()
    enable_compilation_cache(_jax_cache_dir())
    try:
        return run_entry(entry, *args)
    finally:
        for name, value in before.items():
            jax.config.update(name, value)
        compilation_cache.reset_cache()


@functools.cache
def trained_pair(preset, replacements, args, data):
    """(port, jax): the projects of write_project(preset, replacements)
    trained by the port's `mp train --device cpu *args` and by the JAX
    package's `mp train --num_devices 1 *args`, on toy_data(*data) made
    once for both. Memoised per process, so each configuration trains
    once: a caller that writes into a project copies it first, or writes
    under a name of its own."""
    from multiplanarunet_tpu.bin import train as j_train
    from multiplanarunet_tpu_torch.bin import mp as t_mp

    root = Path(_remove_later(tempfile.mkdtemp(prefix="mp_pair_")))
    toy_data(root / "data", *data)
    port = write_project(root, "port", preset, replacements)
    jax_proj = write_project(root, "jax", preset, replacements)
    run_entry(t_mp.entry_func, "train", "--project_dir", str(port),
              "--device", "cpu", *args)
    run_jax_entry(j_train.entry_func, "--project_dir", str(jax_proj),
                  "--num_devices", "1", *args)
    return port, jax_proj
