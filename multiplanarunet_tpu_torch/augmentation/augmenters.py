"""Batch augmenters (config surface of
`multiplanarunet_tpu/augmentation/augmenters.py`): `Elastic2D` and
`Elastic3D` take the same YAML kwargs (alpha and sigma as scalars or
[lo, hi] ranges drawn per sample, apply_prob, aug_weight replacing the
sample weight of augmented elements, seed) and deform the whole batch of
slices or boxes on its device in one call of
`ops.elastic.elastic_deform_{2d,3d}_batch`.

Per batch, the host draws apply_mask, then alphas, then sigmas from the
augmenter's numpy RandomState, in the JAX package's order, and derives the
batch's key as the JAX package does: fold_in(PRNGKey(seed), count), the
count starting at 1 (without a seed, PRNGKey of one randint(2**31) drawn
at construction). The noise fields come from that key through `ops.prng`
on the batch's device, so a seeded augmenter deforms a batch as the JAX
package's does.
"""

from __future__ import annotations

import numpy as np
import torch

from multiplanarunet_tpu_torch.ops import prng
from multiplanarunet_tpu_torch.ops.elastic import (
    elastic_deform_2d_batch,
    elastic_deform_3d_batch,
)


def _validate_range(value, name):
    if isinstance(value, (list, tuple)):
        if len(value) != 2:
            raise ValueError(f"{name} range must have 2 numbers, got {value}")
        if value[1] <= value[0]:
            raise ValueError(f"{name} upper bound <= lower bound: {value}")
    return value


class Augmenter:
    """Base: callable on (batch_x, batch_y, batch_w, bg_values)."""

    def __call__(self, batch_x, batch_y, batch_w=None, bg_values=None):
        raise NotImplementedError


class Elastic(Augmenter):
    """Random elastic deformation of every batch element (on its
    device)."""

    deform_fn = None  # set by subclasses
    __name__ = "Elastic"

    def __init__(self, alpha, sigma, apply_prob, aug_weight=0.33, seed=None):
        self._alpha = _validate_range(alpha, "alpha")
        self._sigma = _validate_range(sigma, "sigma")
        if not 0 <= apply_prob <= 1:
            raise ValueError(f"apply_prob must be in [0, 1], got {apply_prob}")
        self.apply_prob = apply_prob
        self.weight = aug_weight
        self._rng = np.random.RandomState(seed)
        self._key = prng.PRNGKey(seed if seed is not None
                                 else self._rng.randint(2 ** 31))
        self._count = 0

    def _draw(self, value, n):
        if isinstance(value, (list, tuple)):
            return self._rng.uniform(value[0], value[1], size=n)
        return np.full(n, float(value))

    def _next_count(self):
        """The next batch's count: its key is fold_in(base_key, count)."""
        self._count += 1
        return self._count

    @property
    def base_key(self):
        """The fixed base PRNG key; fold_in(base_key, count) with
        `draw_batch_params_host`'s count is `draw_batch_params`' key."""
        return self._key

    def draw_batch_params(self, batch_size):
        """One batch's draws: (key, alphas, sigmas, apply_mask), in the
        JAX package's order."""
        count, *params = self.draw_batch_params_host(batch_size)
        return (prng.fold_in(self._key, count), *params)

    def draw_batch_params_host(self, batch_size):
        """`draw_batch_params` with the batch's count in place of its key:
        (count, alphas, sigmas, apply_mask)."""
        apply_mask = self._rng.rand(batch_size) <= self.apply_prob
        alphas = self._draw(self._alpha, batch_size)
        sigmas = self._draw(self._sigma, batch_size)
        return self._next_count(), alphas, sigmas, apply_mask

    def __call__(self, batch_x, batch_y, batch_w=None, bg_values=None):
        """Deform (B, *spatial, C) images and (B, *spatial[, 1]) labels;
        returns (images, float32 labels or None, weights with aug_weight
        where applied)."""
        B, C = batch_x.shape[0], batch_x.shape[-1]
        dev = batch_x.device
        lab = (torch.zeros(batch_x.shape[:-1], device=dev)
               if batch_y is None else batch_y.float())
        if lab.shape[-1] == 1 and lab.dim() == batch_x.dim():
            lab = lab[..., 0]
        key, alphas, sigmas, apply_mask = self.draw_batch_params(B)
        if bg_values is None:
            bg = np.zeros((B, C), np.float32)
        else:
            bg = np.array(np.broadcast_to(
                np.asarray(bg_values, np.float32).reshape(B, -1), (B, C)))
        x_out, y_out = type(self).deform_fn(key, batch_x, lab, alphas,
                                            sigmas, apply_mask, bg)
        if batch_w is not None:
            batch_w = np.asarray(batch_w, np.float32).copy()
            batch_w[apply_mask] = self.weight
        return x_out, (None if batch_y is None else y_out), batch_w

    def __str__(self):
        return (f"{self.__name__}(alpha={self._alpha}, sigma={self._sigma}, "
                f"apply_prob={self.apply_prob:.3f})")

    __repr__ = __str__


class Elastic2D(Elastic):
    """Elastic deformation of 2D slice batches (B, d, d, C)."""

    deform_fn = staticmethod(elastic_deform_2d_batch)
    __name__ = "Elastic2D"


class Elastic3D(Elastic):
    """Elastic deformation of 3D box batches (B, d, d, d, C)."""

    deform_fn = staticmethod(elastic_deform_3d_batch)
    __name__ = "Elastic3D"


AUGMENTERS = {"Elastic2D": Elastic2D, "Elastic3D": Elastic3D}


def build_augmenters(config_list, seed=None):
    """Augmenters from the YAML 'augmenters' list of {cls_name, kwargs};
    an unknown class raises ValueError."""
    out = []
    for i, spec in enumerate(config_list or []):
        name = spec["cls_name"]
        if name not in AUGMENTERS:
            raise ValueError(f"Unknown augmenter {name!r} (available: "
                             f"{sorted(AUGMENTERS)})")
        kwargs = dict(spec.get("kwargs", {}))
        if seed is not None:
            kwargs.setdefault("seed", seed + i)
        out.append(AUGMENTERS[name](**kwargs))
    return out
