"""The `jax.random` subset the JAX package calls, bit for bit: keys,
`split`, `fold_in`, 32-bit draws, `uniform` and `permutation`.

The stream reproduced is JAX 0.9's default PRNG, threefry2x32 with
`jax_threefry_partitionable` on (the default since JAX 0.5), under
`jax_enable_x64` off:

- a key is the numpy uint32[2] that `jax.random.PRNGKey(seed)` holds:
  (0, seed mod 2^32) for an integer seed;
- `split(key, num)[i]` is threefry2x32(key, (0, i)), both output words;
- `fold_in(key, d)` is threefry2x32(key, (0, d mod 2^32));
- `random_bits(key, shape)` hashes the counter pair (hi, lo) of each flat
  index i = hi * 2^32 + lo and returns the XOR of the two output words;
- `uniform` puts a draw's top 23 bits under the exponent of 1.0, subtracts
  1 and scales into [minval, maxval) in float32, then takes
  max(minval, .) (`jax/_src/random.py:_uniform`);
- `permutation(key, n)` runs ceil(3 ln n / ln(2^32 - 1)) rounds of: split,
  32-bit keys for every element, a stable sort of the elements by them.

A JAX release that changes the default PRNG or flips
`jax_threefry_partitionable` changes the stream these functions give.

Keys, `split` and `fold_in` are tiny and run on the host in numpy. The
functions that draw tensors (`random_bits`, `uniform`, `permutation`)
take the device to draw on (the card unless the caller names the CPU).
On a CUDA device they launch `csrc/threefry.cu` through
`threefry2x32`, which counts its launches in `threefry2x32.launches`;
a failed launch raises. On the CPU they run `threefry2x32_reference`, the
plain PyTorch version: the same rounds in int64 tensors masked to 32
bits.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from multiplanarunet_tpu_torch._device import resolve_device
from multiplanarunet_tpu_torch.ops._build import KernelLaunchError, kernels

_MASK = 0xFFFFFFFF
# Threefry-2x32's rotation constants for the rounds of odd and even
# groups, and its key-schedule parity word (Salmon et al. 2011)
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# What the kernel writes (its `mode` argument): 32-bit draws or uniforms
BITS, UNIFORM = 0, 1


def _hash_np(key, x0, x1):
    """threefry2x32 of numpy uint32 counter arrays under `key`."""
    k0, k1 = (np.uint32(k) for k in key)
    x0, x1 = (np.asarray(x, np.uint32) for x in (x0, x1))
    with np.errstate(over="ignore"):
        def rotl(v, r):
            return (v << np.uint32(r)) | (v >> np.uint32(32 - r))
        ks = (k0, k1, np.uint32(k0 ^ k1 ^ np.uint32(_PARITY)))
        x0, x1 = x0 + ks[0], x1 + ks[1]
        for g in range(5):
            for r in _ROTATIONS[g % 2]:
                x0 = x0 + x1
                x1 = rotl(x1, r) ^ x0
            x0 = x0 + ks[(g + 1) % 3]
            x1 = x1 + ks[(g + 2) % 3] + np.uint32(g + 1)
    return x0, x1


def PRNGKey(seed):
    """The raw key of `jax.random.PRNGKey(seed)` (64-bit off): uint32
    (0, seed mod 2^32)."""
    return np.array([0, int(seed) & _MASK], np.uint32)


def _as_key(key):
    key = np.asarray(key, np.uint32)
    if key.shape != (2,):
        raise ValueError(f"a PRNG key is a uint32[2]; got shape {key.shape}")
    return key


def split(key, num=2):
    """`jax.random.split(key, num)`: a (num, 2) uint32 array of keys."""
    i = np.arange(int(num), dtype=np.uint64)
    y0, y1 = _hash_np(_as_key(key), (i >> np.uint64(32)).astype(np.uint32),
                      (i & np.uint64(_MASK)).astype(np.uint32))
    return np.stack([y0, y1], axis=-1)


def fold_in(key, data):
    """`jax.random.fold_in(key, data)`: the key hashed with the counter
    (0, data mod 2^32)."""
    y0, y1 = _hash_np(_as_key(key), np.zeros(1, np.uint32),
                      np.array([int(data) & _MASK], np.uint32))
    return np.array([y0[0], y1[0]], np.uint32)


def num_shuffle_rounds(n):
    """The sort rounds of `jax.random.permutation` over n elements
    (`jax/_src/random.py:_shuffle`, exponent 3)."""
    return int(np.ceil(3 * np.log(max(1, int(n)))
                       / np.log(np.iinfo(np.uint32).max)))


def _f32(x):
    return float(np.float32(x))


def _affine(minval, maxval, scale):
    """(span, minval, scale) as float32 numbers: `uniform` computes
    max(minval, u * span + minval) * scale with span = maxval - minval
    rounded to float32, as JAX converts both bounds first."""
    lo, hi = np.float32(minval), np.float32(maxval)
    return _f32(hi - lo), _f32(lo), _f32(scale)


def threefry2x32_reference(key, n, mode=BITS, span=1.0, minval=0.0,
                           scale=1.0, device="cpu"):
    """Plain PyTorch version of the kernel: n values of the stream of
    `key` in flat order, on `device`. mode BITS: the 32-bit draws as int32
    bit patterns; UNIFORM: float32 max(minval, u * span + minval) * scale
    with u in [0, 1) from the draw's top 23 bits (`uniform`'s arguments
    through `_affine`)."""
    key = _as_key(key)
    i = torch.arange(int(n), dtype=torch.int64, device=device)

    def rotl(v, r):
        return ((v << r) | (v >> (32 - r))) & _MASK

    ks = (int(key[0]), int(key[1]), int(key[0] ^ key[1] ^ _PARITY))
    x0 = ((i >> 32) + ks[0]) & _MASK
    x1 = ((i & _MASK) + ks[1]) & _MASK
    for g in range(5):
        for r in _ROTATIONS[g % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = rotl(x1, r) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & _MASK
        x1 = (x1 + ks[(g + 2) % 3] + g + 1) & _MASK
    bits = x0 ^ x1
    if mode == BITS:
        return torch.where(bits >= 2 ** 31, bits - 2 ** 32,
                           bits).to(torch.int32)
    u = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    u = u - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    out = torch.maximum(lo, u * _f32(span) + lo)
    return out * _f32(scale)


def threefry2x32(key, n, mode=BITS, span=1.0, minval=0.0, scale=1.0,
                 device=None):
    """n values of the stream of `key` in flat order (as
    `threefry2x32_reference` describes), drawn on `device`: the kernel on
    a CUDA device (counted in `threefry2x32.launches`), the plain version
    on the CPU."""
    device = resolve_device(device)
    key = _as_key(key)
    n = int(n)
    if mode not in (BITS, UNIFORM):
        raise ValueError(f"threefry2x32 mode is {BITS} (bits) or "
                         f"{UNIFORM} (uniform); got {mode}")
    if device.type == "cpu":
        return threefry2x32_reference(key, n, mode, span, minval, scale,
                                      device)
    if device.type != "cuda":
        raise ValueError(f"threefry2x32 runs on cpu or cuda; got {device}")
    dtype = torch.int32 if mode == BITS else torch.float32
    out = torch.empty(n, dtype=dtype, device=device)
    if n == 0:
        return out
    fn = kernels().threefry
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(out.data_ptr(), n, int(key[0]), int(key[1]), mode,
                 _f32(span), _f32(minval), _f32(scale), stream)
    if err != 0:
        raise KernelLaunchError(f"threefry2x32 kernel launch failed: "
                                f"cudaError {err}")
    threefry2x32.launches += 1
    return out


threefry2x32.launches = 0


def _shape(shape):
    shape = (int(shape),) if np.ndim(shape) == 0 else tuple(int(s)
                                                            for s in shape)
    if any(s < 0 for s in shape):
        raise ValueError(f"negative dimension in shape {shape}")
    return shape


def random_bits(key, shape, device=None):
    """`jax.random.bits(key, shape)` (uint32) on `device`, as a
    torch.uint32 tensor."""
    shape = _shape(shape)
    bits = threefry2x32(key, math.prod(shape), BITS, device=device)
    return bits.view(torch.uint32).reshape(shape)


def uniform(key, shape, minval=0.0, maxval=1.0, device=None, scale=1.0):
    """`jax.random.uniform(key, shape, float32, minval, maxval)` on
    `device`, times `scale` in float32 (a variance-scaling initializer's
    `uniform(key, shape, dtype, -1) * sqrt(3 * variance)` in one pass)."""
    shape = _shape(shape)
    span, lo, scale = _affine(minval, maxval, scale)
    out = threefry2x32(key, math.prod(shape), UNIFORM, span, lo, scale,
                       device=device)
    return out.reshape(shape)


def _shuffle(key, n, device, bits_fn):
    key = _as_key(key)
    x = torch.arange(int(n), dtype=torch.int64, device=device)
    for _ in range(num_shuffle_rounds(n)):
        key, subkey = split(key)
        bits = bits_fn(subkey, x.numel(), BITS, device=device)
        order = torch.sort(bits.to(torch.int64) & _MASK, stable=True).indices
        x = x[order]
    return x


def permutation(key, n, device=None):
    """`jax.random.permutation(key, n)`: a shuffle of arange(n) (int64) on
    `device`. Each round splits the key, draws a 32-bit sort key per
    element and sorts the elements by them, stably (XLA's sort_key_val is
    stable; equal keys keep their order)."""
    return _shuffle(key, n, resolve_device(device), threefry2x32)


def permutation_reference(key, n, device="cpu"):
    """`permutation` with the plain version's draws on any device."""
    return _shuffle(key, n, torch.device(device), threefry2x32_reference)
