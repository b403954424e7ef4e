"""The port's threefry2x32 stream (`multiplanarunet_tpu_torch/ops/prng.py`)
against `jax.random` itself, exactly: keys, split, fold_in, 32-bit draws,
uniform and permutation, through the plain PyTorch version on the CPU
(the CUDA kernel is held against it in chip_smoke.py)."""
import jax
import numpy as np
import pytest
import torch

from multiplanarunet_tpu_torch.ops import prng
from tests.torch_projects import torch_threads  # noqa: F401

SEEDS = [0, 1, 42, 2 ** 31 - 1]
SHAPES = [(1,), (7,), (2, 33, 33), (3, 2, 16, 16, 16)]


def _key(seed):
    return np.asarray(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    got = prng.PRNGKey(seed)
    assert got.dtype == np.uint32 and got.shape == (2,)
    np.testing.assert_array_equal(got, _key(seed))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 3])
def test_split_matches_jax(seed, num):
    want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), num))
    got = prng.split(prng.PRNGKey(seed), num)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", [1, 7, 2 ** 32 - 1])
def test_fold_in_matches_jax(seed, data):
    want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed),
                                         np.uint32(data)))
    np.testing.assert_array_equal(prng.fold_in(prng.PRNGKey(seed), data),
                                  want)


@pytest.mark.parametrize("shape", SHAPES)
def test_random_bits_match_jax(shape):
    key = jax.random.fold_in(jax.random.PRNGKey(3), 11)
    want = np.asarray(jax.random.bits(key, shape, np.uint32))
    got = prng.random_bits(np.asarray(key), shape, device="cpu")
    assert got.dtype == torch.uint32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bounds", [(-1.0, 1.0), (0.0, 1.0)])
def test_uniform_matches_jax(shape, bounds):
    key = jax.random.split(jax.random.PRNGKey(5), 3)[2]
    want = np.asarray(jax.random.uniform(key, shape, minval=bounds[0],
                                         maxval=bounds[1]))
    got = prng.uniform(np.asarray(key), shape, *bounds, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


@pytest.mark.parametrize("n,rounds", [(1000, 1), (100_000, 2),
                                      (3_000_000, 3)])
def test_permutation_matches_jax(n, rounds):
    """1, 2 and 3 sort rounds; at 100k and 3M elements the 32-bit sort
    keys collide, so the sort's stability is part of the result."""
    assert prng.num_shuffle_rounds(n) == rounds
    key = jax.random.PRNGKey(n)
    want = np.asarray(jax.random.permutation(key, n))
    got = prng.permutation(np.asarray(key), n, device="cpu")
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_draws_default_to_the_card(monkeypatch):
    """No device named: the card, so without one the draw raises instead
    of running on the CPU; nothing is built on the CPU path."""
    from multiplanarunet_tpu_torch._device import CudaUnavailableError
    from multiplanarunet_tpu_torch.ops import _build

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for draw in (lambda: prng.uniform(prng.PRNGKey(0), (4,)),
                 lambda: prng.random_bits(prng.PRNGKey(0), (4,)),
                 lambda: prng.permutation(prng.PRNGKey(0), 4)):
        with pytest.raises(CudaUnavailableError):
            draw()
    before = prng.threefry2x32.launches
    prng.uniform(prng.PRNGKey(0), (4,), device="cpu")
    assert prng.threefry2x32.launches == before
    assert _build.kernels.cache_info().currsize == 0
