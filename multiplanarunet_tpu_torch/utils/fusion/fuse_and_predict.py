"""Fused multi-view inference, in torch.

Port of the shear path of
`multiplanarunet_tpu/utils/fusion/fuse_and_predict.py:MultiViewPredictor`.
For each view, on the device:

    plane-stack resample (6 Catmull-Rom shear passes, bf16)
        -> U-Net over plane chunks (bf16 probabilities)
        -> remap onto the padded voxel grid (6 linear passes, f32 out)
        -> accum += W[v] * mapped  (float32 fusion accumulator)

then bias + argmax (uint8 class map) or the fused probabilities. Because
the fusion model is linear in the per-view probabilities, accumulating
``W[v] * mapped`` per view is the fusion.

Not ported yet: the exact-gather resampler and the channel-grouped remap.
A view whose affine does not factor, or whose plans exceed the memory
guard, raises `ShearUnsupportedError` instead of falling back.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from multiplanarunet_tpu_torch.ops import geometry
from multiplanarunet_tpu_torch.ops.shear import shear_resample
from multiplanarunet_tpu_torch.ops.shear_plan import (
    plan_plane_stack,
    plan_stage_bytes,
    plan_view_remap,
)


class ShearUnsupportedError(NotImplementedError):
    """A view needs a resampler the port does not have yet."""


def _device_memory_bytes(device):
    if device.type == "cuda":
        return float(torch.cuda.get_device_properties(device).total_memory)
    return float(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))


class MultiViewPredictor:
    """Runs fused multi-view inference for one model configuration on one
    device; reusable across images.

    model: an inference `nn.Module` taking (B, C, d, d) and returning
    (B, n_classes, d, d) probabilities, already on `device` and in eval
    mode. `image` arguments are objects with `.shape`, `.affine` and
    `.interpolator` (an `image.volume_sampler.VolumeSampler`)."""

    # Memory guards as fractions of the device's memory. The JAX package's
    # constants (3.2e9 per bf16 stage, 11e9 remap peak) were sized for a
    # 16 GB chip; these keep the same proportions of whatever card runs.
    STAGE_FRACTION = 0.2
    REMAP_PEAK_FRACTION = 0.6875

    def __init__(self, model, sample_dim, real_space_span, n_classes, device,
                 chunk=None):
        self.model = model
        self.dim = int(sample_dim)
        self.span = float(real_space_span)
        self.n_classes = int(n_classes)
        self.device = torch.device(device)
        depth = getattr(model, "depth", None)
        if depth and self.dim % (2 ** depth):
            raise ValueError(
                f"sample_dim={self.dim} is not divisible by 2^depth="
                f"{2 ** depth}: the U-Net would crop its output below the "
                f"input size and the prediction remap would fail. Use a dim "
                f"divisible by {2 ** depth}.")
        # Plane batch per U-Net step. With chunk=None the batch adapts to
        # each stack's plane count so no padded planes run through the
        # U-Net (P_pad = steps * 2ceil(P / 2steps)), as in the JAX package.
        self.chunk = None if chunk is None else int(chunk)
        self._chunk_target = 48 if self.dim <= 256 else 16
        mem = _device_memory_bytes(self.device)
        self.stage_bytes_max = self.STAGE_FRACTION * mem
        self.remap_peak_bytes_max = self.REMAP_PEAK_FRACTION * mem
        self._events = []

    # ----------------------------------------------------------- planning
    def _chunk_for(self, P_pad):
        """U-Net plane batch for a P_pad-plane stack: the largest even
        divisor of P_pad that is <= the target (what _prepare_offsets
        padded for)."""
        if self.chunk is not None:
            return self.chunk
        t = self._chunk_target
        if P_pad <= t:
            return P_pad
        return max(d for d in range(2, t + 1, 2) if P_pad % d == 0)

    def _plane_offsets(self, image, n_planes):
        sample_res = self.span / (self.dim - 1)
        if n_planes == "by_radius":
            bounds = geometry.get_bounding_sphere_real_radius(image)
            n = int(2 * bounds / sample_res)
        else:
            extra = 0
            if n_planes == "same":
                n = self.dim
            elif isinstance(n_planes, str) and n_planes.startswith("same+"):
                extra = int(n_planes.split("+")[-1])
                n = self.dim + extra
            else:
                n = int(n_planes)
            bounds = (self.span + extra * sample_res) / 2
        return np.linspace(-bounds, bounds, n).astype(np.float32)

    def _prepare_offsets(self, image, n_planes):
        """(chunk-padded offsets, n_valid) for an n_planes spec."""
        offsets = self._plane_offsets(image, n_planes)
        n_valid = len(offsets)
        if self.chunk is not None:
            P_pad = -(-n_valid // self.chunk) * self.chunk
        else:
            steps = -(-n_valid // self._chunk_target)
            P_pad = steps * 2 * (-(-n_valid // (2 * steps)))
        if P_pad != n_valid:
            step = offsets[1] - offsets[0]
            extra = offsets[-1] + step * np.arange(1, P_pad - n_valid + 1)
            offsets = np.concatenate([offsets, extra]).astype(np.float32)
        return offsets, n_valid

    @staticmethod
    def _remap_transform(image, basis, true_shape):
        """(M, t) taking voxel INDEX -> plane coords for one view basis."""
        A = np.asarray(image.affine, np.float64)[:3, :3]
        center = A @ ((np.asarray(true_shape) - 1) / 2.0)
        inv_basis = np.linalg.inv(basis.astype(np.float64))
        return ((inv_basis @ A).astype(np.float32),
                (-inv_basis @ center).astype(np.float32))

    def _grid_params(self, offsets):
        """(g0, g_step, o0, o_step) of the plane sample grid."""
        g0 = float(-(self.span // 2))
        g_step = (-2.0 * g0) / (self.dim - 1)
        return g0, g_step, float(offsets[0]), float(offsets[1] - offsets[0])

    def _fusion_Wb(self, fusion_params, n_views):
        """Per-view weights W (None for sum fusion) + bias b (zeros when
        unfused, which is argmax-neutral)."""
        if fusion_params is None:
            return None, np.zeros((self.n_classes,), np.float32)
        W = np.asarray(fusion_params["fusion"]["W"], np.float32)
        if W.shape[0] != n_views:
            raise ValueError(
                f"Fusion weights cover {W.shape[0]} views, got {n_views}")
        b = np.asarray(fusion_params["fusion"]["b"], np.float32).reshape(-1)
        return W, b

    def _plan_shear_views(self, image, bases, Mts, offsets, n_valid):
        """Per-view ((stack plan, bounds), (remap plan, bounds)). Raises
        ShearUnsupportedError where the JAX package would fall back to the
        exact gather path or the channel-grouped remap."""
        sampler = image.interpolator
        rot = (np.eye(3) if sampler.rot_mat is None
               else np.asarray(sampler.rot_mat, np.float64))
        vol_shape = sampler.padded_shape()
        g0, g_step, o0, o_step = self._grid_params(offsets)
        P_pad = len(offsets)
        valid_shape = tuple(int(s) for s in sampler.valid_shape)
        n_ch = int(sampler.n_channels)
        # Peak memory of a remap: the f32 accumulator, the mapped f32
        # volume, the bf16 prediction stack and two live bf16 stages
        accum_bytes = float(np.prod(vol_shape)) * self.n_classes * 4
        pred_bytes = float(self.dim * self.dim * P_pad) * self.n_classes * 2
        later = ("the exact-gather resampler and the channel-grouped remap "
                 "are not ported yet")
        plans = []
        for v, (basis, (M, t)) in enumerate(zip(bases, Mts)):
            s_plan, s_Nc = plan_plane_stack(
                basis, rot, sampler.origin, sampler.spacing,
                g0, g_step, o0, o_step, vol_shape, self.dim, P_pad)
            if not s_plan.valid:
                raise ShearUnsupportedError(
                    f"view {v}: the plane-stack affine does not factor into "
                    f"shear passes; {later}")
            if plan_stage_bytes(s_plan, n_ch) > self.stage_bytes_max:
                raise ShearUnsupportedError(
                    f"view {v}: a plane-stack stage exceeds the memory guard "
                    f"({self.stage_bytes_max:.3g} B); {later}")
            r_plan, r_Nc = plan_view_remap(
                M, t, g0, g_step, o0, o_step,
                (self.dim, self.dim, P_pad), vol_shape)
            if not r_plan.valid:
                raise ShearUnsupportedError(
                    f"view {v}: the remap affine does not factor into shear "
                    f"passes; {later}")
            r_stage = plan_stage_bytes(r_plan, self.n_classes)
            base = accum_bytes + pred_bytes
            peak = max(2 * r_stage + base, r_stage + accum_bytes + base)
            if (r_stage > self.stage_bytes_max
                    or peak > self.remap_peak_bytes_max):
                raise ShearUnsupportedError(
                    f"view {v}: the remap needs {peak:.3g} B at its peak, "
                    f"over the memory guard ({self.remap_peak_bytes_max:.3g}"
                    f" B); {later}")
            # Padded tail planes are out of bounds for the remap
            plans.append(((s_plan, s_Nc + (valid_shape,)),
                          (r_plan, r_Nc + ((self.dim, self.dim, n_valid),))))
        return plans

    # ------------------------------------------------------------ running
    def _mark(self, name):
        """Record a CUDA event named `name` on the current stream (no-op
        off the card); `stage_ms` reads the gaps between marks."""
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._events.append((name, ev))

    def stage_ms(self):
        """{stage: milliseconds} of the last predict_image on the card,
        from CUDA events, summed over views: 'stack', 'unet', 'remap'
        (with the accumulation), 'fuse', and 'start' (the gaps between a
        view's end and the next stage's start). Empty off the card."""
        if not self._events:
            return {}
        torch.cuda.synchronize(self.device)
        out = {}
        for (_, start), (name, end) in zip(self._events, self._events[1:]):
            out[name] = out.get(name, 0.0) + start.elapsed_time(end)
        return out

    def _unet_stack(self, stack):
        """(d, d, P_pad, C) stack -> (d, d, P_pad, n_classes) bf16
        probabilities, running the model over plane chunks."""
        d, _, P_pad, _ = stack.shape
        planes = stack.permute(2, 3, 0, 1)  # (P_pad, C, d, d)
        chunk = self._chunk_for(P_pad)
        pred = torch.empty((d, d, P_pad, self.n_classes),
                           dtype=torch.bfloat16, device=stack.device)
        for p in range(0, P_pad, chunk):
            probs = self.model(planes[p:p + chunk].contiguous())
            pred[:, :, p:p + chunk] = probs.permute(2, 3, 0, 1)
        return pred

    @torch.inference_mode()
    def predict_image(self, image, views, fusion_params=None,
                      n_planes="same+20", return_per_view=True,
                      return_probs=False):
        """Run all views over one image and fuse.

        Returns (fused, per_view) as numpy arrays cropped to the image's
        true shape: `fused` is the uint8 argmax class map, or with
        return_probs the fused probabilities (softmax(accum + b) with
        learned fusion, accum / n_views without); `per_view` is a list of
        per-view uint8 argmax maps, or None."""
        sampler = image.interpolator
        true_shape = tuple(int(s) for s in image.shape[:3])
        offsets, n_valid = self._prepare_offsets(image, n_planes)
        n_views = len(views)
        W, b = self._fusion_Wb(fusion_params, n_views)
        bases = [geometry.plane_basis(view, noise_sd=0.0) for view in views]
        Mts = [self._remap_transform(image, basis, true_shape)
               for basis in bases]
        plans = self._plan_shear_views(image, bases, Mts, offsets, n_valid)

        dev = self.device
        self._events = []
        volume = sampler.device_volume_unpacked(dev)
        out_shape = tuple(int(s) for s in volume.shape[:3])
        fill = sampler.scaled_bg_value
        onehot_bg = np.zeros((self.n_classes,), np.float32)
        onehot_bg[0] = 1.0
        ws = (torch.from_numpy(W) if W is not None
              else torch.ones((n_views, self.n_classes))).to(dev)
        accum = torch.zeros(out_shape + (self.n_classes,),
                            dtype=torch.float32, device=dev)
        per_view = [] if return_per_view else None
        crop = tuple(slice(0, s) for s in true_shape)
        for v, ((s_plan, s_bounds), (r_plan, r_bounds)) in enumerate(plans):
            self._mark("start")
            # Catmull-Rom forward passes keep the input sharp; bf16 passes
            # halve the bandwidth (the U-Net computes in bf16 anyway)
            stack = shear_resample(volume, s_plan, fill, method="cubic",
                                   compute_dtype=torch.bfloat16,
                                   exact_bounds=s_bounds)
            self._mark("stack")
            pred = self._unet_stack(stack)
            del stack
            self._mark("unet")
            mapped = shear_resample(pred, r_plan, onehot_bg, method="linear",
                                    compute_dtype=torch.bfloat16,
                                    out_dtype=torch.float32,
                                    exact_bounds=r_bounds)
            del pred
            if return_per_view:
                per_view.append(mapped[crop].argmax(dim=-1)
                                .to(torch.uint8).cpu().numpy())
            accum += mapped.mul_(ws[v])  # in place: no second f32 volume
            del mapped
            self._mark("remap")

        b_t = torch.from_numpy(b).to(dev)
        self._mark("start")
        if return_probs:
            fused = (torch.softmax(accum + b_t, dim=-1)
                     if fusion_params is not None else accum / n_views)
            out = fused[crop].cpu().numpy()
        else:
            # argmax is invariant to softmax and to the sum-fusion 1/n
            # scaling, so bias + argmax is the fused class map
            out = (accum + b_t)[crop].argmax(dim=-1).to(torch.uint8)
            out = out.cpu().numpy()
        self._mark("fuse")
        return out, per_view
