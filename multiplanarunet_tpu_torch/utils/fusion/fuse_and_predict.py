"""Fused multi-view inference, in torch.

Port of `multiplanarunet_tpu/utils/fusion/fuse_and_predict.py:
MultiViewPredictor`. For each view, on the device:

    plane-stack resample  ->  U-Net over plane chunks (bf16 probabilities)
        ->  remap onto the padded voxel grid
        ->  accum += W[v] * mapped  (float32 fusion accumulator)

then bias + argmax (uint8 class map) or the fused probabilities. Because
the fusion model is linear in the per-view probabilities, accumulating
``W[v] * mapped`` per view is the fusion. `predict_image_sharded` runs the
views over several devices (view v on device v % n, the JAX package's
`_predict_sharded_shear` and its gather fallback) and adds the partial
accumulators on the first.

Two resamplers:

  * ``shear``: shear-decomposed affine resampling (`ops.shear`), 6
    Catmull-Rom passes for the stack and 6 linear passes for the remap,
    each a launch of the CUDA shear-pass kernel on the card. A remap that
    would not fit the memory guard runs over channel groups in bf16, or
    else through the slab-scanned gather remap (mixed mode).
  * ``gather``: the exact corner-packed trilinear stack and nearest remap
    of `ops.interp`, one loop over views.

``auto`` (default) takes shear when every view's plane stack factors
within the guard and falls back to gather for the whole image otherwise.

Fusion training (`mp train_fusion`) reads each view's mapped probabilities
through `predict_views_mapped` / `predict_views_points`, which always take
the exact gather path, as the JAX package's do.

`predict_single` is the one-image convenience over both model kinds: the
per-view mapped probabilities (iso_live) or `pred_3D_iso`'s box sums
(iso_live_3d).

The 3D model's inference (`mp predict_3D`) is `pred_3D_iso` (isotropic
scanner-space boxes: the base tiling, then extra random boxes, each
sampled, predicted and scatter-added onto its nearest voxels) and
`predict_3D_patches(_binary)` (voxel-space patches added slice-wise), as
plain loops on the device over chunks of boxes in the JAX scans' box
order, with the volume staged once.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import os

import numpy as np
import torch

from multiplanarunet_tpu_torch._device import resolve_device
from multiplanarunet_tpu_torch.models.unet import UNet
from multiplanarunet_tpu_torch.ops import geometry, prng
from multiplanarunet_tpu_torch.ops.interp import (
    accum_view_pred_affine,
    map_view_pred_affine,
    sample_box_batch,
    sample_plane_stack_packed,
    scatter_box_pred,
)
from multiplanarunet_tpu_torch.ops.shear import shear_resample
from multiplanarunet_tpu_torch.ops.shear_plan import (
    plan_plane_stack,
    plan_stage_bytes,
    plan_view_remap,
)
from multiplanarunet_tpu_torch.utils import trace


def _device_memory_bytes(device):
    if device.type == "cuda":
        return float(torch.cuda.get_device_properties(device).total_memory)
    return float(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))


def class_map_counts(cls, labels, n_classes):
    """(3, n_classes) int64 confusion counts (tp, rel = |labels == c|,
    sel = |cls == c|) of a class map against labels of the same shape,
    computed where the tensors lie; feed `evaluate.metrics.
    dice_from_counts`."""
    tp, rel, sel = [], [], []
    for c in range(n_classes):
        s1 = labels == c
        s2 = cls == c
        tp.append((s1 & s2).sum())
        rel.append(s1.sum())
        sel.append(s2.sum())
    return torch.stack([torch.stack(tp), torch.stack(rel), torch.stack(sel)])


def _inference_model(model):
    """The form of `model` the predictor runs, by the JAX predictor's rule
    (`multiplanarunet_tpu/utils/fusion/fuse_and_predict.py`,
    MultiViewPredictor.__init__):

      * a U-Net's decoder as `DilatedUpConv`, unless the model has the
        sub-pixel decoder or MP_PREDICT_DILATED=0;
      * a 2D `UNet` (that class exactly: no UNet3D) with lane_pad 0 whose
        filter ladder holds a count that is not a multiple of
        MP_PREDICT_LANE_PAD (default 8; 0 turns it off) zero-padded to
        that multiple (`lane_pad_variables`, exact);
      * a U-Net built with `flatten_output` returning (B, C, *spatial)
        again (the JAX predictor reshapes the flattened output back to
        its planes).

    Either way the result is a twin with its own copy of the weights, on
    the model's device, in its dtype and mode (`UNet.twin`); `model`
    itself is never changed. Any other model (an oracle, a multi-task
    model) is returned as it is. The defaults are the JAX package's; on
    an NVIDIA H100 each form alone and both together run the main path's
    U-Net faster than the plain one (`chip_smoke.py`,
    `phase_unet_variants`; the times are in PERF.md)."""
    overrides = {}
    if (getattr(model, "dilated_upconv", None) is False
            and not getattr(model, "subpixel_decoder", False)
            and os.environ.get("MP_PREDICT_DILATED", "1") != "0"):
        overrides["dilated_upconv"] = True
    pad = int(os.environ.get("MP_PREDICT_LANE_PAD", "8") or 0)
    if pad and type(model) is UNet and model.lane_pad == 0:
        ladder = [int(model.init_filters * 2 ** i * model.cf)
                  for i in range(model.depth + 1)]
        if any(f % pad for f in ladder):
            overrides["lane_pad"] = pad
    if getattr(model, "flatten_output", False) and hasattr(model, "twin"):
        overrides["flatten_output"] = False
    return model.twin(**overrides) if overrides else model


class MultiViewPredictor:
    """Runs fused multi-view inference for one model configuration on one
    device; reusable across images.

    model: an inference `nn.Module` taking (B, C, d, d) and returning
    (B, n_classes, d, d) probabilities, already on `device` and in eval
    mode. A U-Net runs in the JAX predictor's inference form, on a twin
    (`_inference_model`); `self.model` is the model that runs. `image`
    arguments are objects with `.shape`, `.affine` and `.interpolator`
    (an `image.volume_sampler.VolumeSampler`)."""

    # Memory guards as fractions of the device's memory. The JAX package's
    # constants (3.2e9 per bf16 stage, 11e9 remap peak) were sized for a
    # 16 GB chip; these keep the same proportions of whatever card runs.
    # The instance attributes stage_bytes_max / remap_peak_bytes_max hold
    # the resulting byte budgets.
    STAGE_FRACTION = 0.2
    REMAP_PEAK_FRACTION = 0.6875

    def __init__(self, model, sample_dim, real_space_span, n_classes, device,
                 chunk=None, logger=None, resampler="auto",
                 stage_dtype="bf16"):
        self.model = _inference_model(model)
        self.dim = int(sample_dim)
        self.span = float(real_space_span)
        self.n_classes = int(n_classes)
        self.device = torch.device(device)
        self.logger = logger
        if self.model is not model:
            self._log(f"U-Net inference form: dilated_upconv="
                      f"{self.model.dilated_upconv}, lane_pad="
                      f"{self.model.lane_pad} (MP_PREDICT_DILATED, "
                      f"MP_PREDICT_LANE_PAD)")
        depth = getattr(model, "depth", None)
        if depth and self.dim % (2 ** depth):
            raise ValueError(
                f"sample_dim={self.dim} is not divisible by 2^depth="
                f"{2 ** depth}: the U-Net would crop its output below the "
                f"input size and the prediction remap would fail. Use a dim "
                f"divisible by {2 ** depth}.")
        if resampler not in ("auto", "shear", "gather"):
            raise ValueError(f"resampler must be 'auto', 'shear' or "
                             f"'gather'; got {resampler!r}")
        self.resampler = resampler
        if stage_dtype not in ("bf16", "u8"):
            raise ValueError(f"stage_dtype must be 'bf16' or 'u8'; got "
                             f"{stage_dtype!r}")
        # 'u8' stages volumes as per-channel affine uint8 codes (half the
        # bf16 host->device bytes), dequantised to bf16 on the device
        self.stage_dtype = stage_dtype
        # Plane batch per U-Net step. With chunk=None the batch adapts to
        # each stack's plane count so no padded planes run through the
        # U-Net (P_pad = steps * 2ceil(P / 2steps)), as in the JAX package.
        self.chunk = None if chunk is None else int(chunk)
        self._chunk_target = 48 if self.dim <= 256 else 16
        mem = _device_memory_bytes(self.device)
        self.stage_bytes_max = self.STAGE_FRACTION * mem
        self.remap_peak_bytes_max = self.REMAP_PEAK_FRACTION * mem
        # Per view of the last predict_image: 'shear', 'grouped:<g>',
        # 'gather-remap' (mixed mode) or 'gather'
        self.remap_modes = []
        # The device spans of the last predict_image (stage_ms reads them)
        # and the number of predict_image calls (the spans' request id)
        self._stages = []
        self._calls = 0
        # Model replicas of predict_image_sharded, per device
        self._replicas = {}

    def _log(self, msg):
        if self.logger:
            self.logger(msg)

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

    def _prepare_offsets(self, image, n_planes):
        """(chunk-padded offsets, n_valid) for an n_planes spec."""
        offsets = geometry.plane_offsets(image, n_planes, self.span, self.dim)
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

    def _remap_group(self, r_plan, vol_shape, P_pad):
        """How one view's remap runs within the memory guards: (mode,
        group) with mode 'shear' (all classes, f32 out), 'grouped' (bf16
        passes over `group` classes at a time) or 'gather-remap'.

        Peak of the all-classes remap: the f32 accumulator and the bf16
        prediction stack stay live throughout; mid pass an input and an
        output stage, in the final pass the last stage next to the mapped
        f32 volume. A grouped remap shrinks every stage with the group
        width while the other groups' finished bf16 parts stay live."""
        nc = self.n_classes
        accum_bytes = float(np.prod(vol_shape)) * nc * 4
        pred_bytes = float(self.dim * self.dim * P_pad) * nc * 2
        base = accum_bytes + pred_bytes
        r_stage = (plan_stage_bytes(r_plan, nc) if r_plan.valid
                   else float("inf"))
        peak_f32 = max(2 * r_stage + base, r_stage + accum_bytes + base)
        if (r_stage <= self.stage_bytes_max
                and peak_f32 <= self.remap_peak_bytes_max):
            return "shear", None
        if r_plan.valid:
            for g in range(nc - 1, 0, -1):
                r_g = plan_stage_bytes(r_plan, g)
                peak_g = 2 * r_g + accum_bytes / 2 + base
                if (r_g <= self.stage_bytes_max
                        and peak_g <= self.remap_peak_bytes_max):
                    return "grouped", g
        return "gather-remap", None

    def _plan_shear_views(self, image, bases, Mts, offsets, n_valid):
        """Per-view ((stack plan, bounds), (remap mode, group, remap plan,
        bounds)), or None when a view's plane-stack affine does not factor
        or its stages exceed the memory guard (the caller then takes the
        gather path). A view whose stack fits but whose remap does not
        even in channel groups remaps through the gather kernel (mixed
        mode)."""
        sampler = image.interpolator
        rot = (np.eye(3) if sampler.rot_mat is None
               else np.asarray(sampler.rot_mat, np.float64))
        vol_shape = sampler.padded_shape()
        g0, g_step, o0, o_step = self._grid_params(offsets)
        P_pad = len(offsets)
        valid_shape = tuple(int(s) for s in sampler.valid_shape)
        n_ch = int(sampler.n_channels)
        plans = []
        for basis, (M, t) in zip(bases, Mts):
            s_plan, s_Nc = plan_plane_stack(
                basis, rot, sampler.origin, sampler.spacing,
                g0, g_step, o0, o_step, vol_shape, self.dim, P_pad)
            if (not s_plan.valid
                    or plan_stage_bytes(s_plan, n_ch) > self.stage_bytes_max):
                return None
            r_plan, r_Nc = plan_view_remap(
                M, t, g0, g_step, o0, o_step,
                (self.dim, self.dim, P_pad), vol_shape)
            mode, group = self._remap_group(r_plan, vol_shape, P_pad)
            # Padded tail planes are out of bounds for the remap
            plans.append(((s_plan, s_Nc + (valid_shape,)),
                          (mode, group, r_plan,
                           r_Nc + ((self.dim, self.dim, n_valid),))))
        return plans

    # ------------------------------------------------------------ running
    def stage_ms(self):
        """{stage: milliseconds} of the last predict_image on the card, from
        its device spans (`utils.trace`), summed over views: 'stack',
        'unet', 'remap' (with the accumulation), 'fuse', and 'start' (the
        gaps between one span's end and the next one's start), 'stage'
        (the volume's host -> device copy and on-device expansion). The
        spans stay for a later `trace.take()`. Empty off the card."""
        spans = [s for s in self._stages if s.timed]
        if not spans:
            return {}
        out = {}
        for s in spans:
            name = s.name.split(".", 1)[1]
            out[name] = out.get(name, 0.0) + s.device_ms()
        out["start"] = sum(a.ms_until(b) for a, b in zip(spans, spans[1:]))
        return out

    def _unet_stack(self, stack, model=None):
        """(d, d, P_pad, C) stack -> (d, d, P_pad, n_classes) bf16
        probabilities, running `model` (this predictor's by default) over
        plane chunks. Each chunk is a dense (chunk, d, d, C) copy handed
        to the model as its (chunk, C, d, d) view: channels-last strides
        for every C (C = 1 included), so cuDNN's NHWC kernels take every
        conv's input and give its output with no transpose around it."""
        model = self.model if model is None else model
        d, _, P_pad, _ = stack.shape
        planes = stack.permute(2, 0, 1, 3)  # (P_pad, d, d, C)
        chunk = self._chunk_for(P_pad)
        pred = torch.empty((d, d, P_pad, self.n_classes),
                           dtype=torch.bfloat16, device=stack.device)
        for p in range(0, P_pad, chunk):
            probs = model(planes[p:p + chunk].contiguous().permute(0, 3, 1, 2))
            pred[:, :, p:p + chunk] = probs.permute(2, 3, 0, 1)
        return pred

    def shear_remap(self, pred, r_plan, r_bounds, group=None):
        """Remap a (d, d, P_pad, n_classes) bf16 prediction stack through
        a shear plan: all classes at once with a float32 result (group
        None), or over channel groups of `group` classes with bf16 passes
        and bf16 parts concatenated. The fill is the one-hot background."""
        nc = self.n_classes
        onehot_bg = np.zeros((nc,), np.float32)
        onehot_bg[0] = 1.0
        if not group:
            return shear_resample(pred, r_plan, onehot_bg, method="linear",
                                  compute_dtype=torch.bfloat16,
                                  out_dtype=torch.float32,
                                  exact_bounds=r_bounds)
        parts = [shear_resample(pred[..., lo:lo + group], r_plan,
                                onehot_bg[lo:lo + group], method="linear",
                                compute_dtype=torch.bfloat16,
                                out_dtype=torch.bfloat16,
                                exact_bounds=r_bounds)
                 for lo in range(0, nc, group)]
        return torch.cat(parts, dim=-1)

    def _stage_volume(self, sampler, packed, device=None):
        device = self.device if device is None else device
        quantize = self.stage_dtype == "u8"
        if packed:
            return sampler.device_volume_packed(device, quantize=quantize)
        return sampler.device_volume_unpacked(device, quantize=quantize)

    def prestage(self, image):
        """The host half of staging this image (scaling, and the uint8
        codes for stage_dtype 'u8'), for an input thread to run ahead of
        predict_image; predict_image copies to the device on the calling
        thread."""
        image.interpolator.prepare_host(quantize=self.stage_dtype == "u8")

    def _per_view_result(self, cls, crop, labels_dev):
        """A per-view uint8 class map fetched to the host, or with staged
        labels its (3, C) confusion counts left on the device."""
        cls = cls[crop]
        if labels_dev is None:
            return cls.cpu().numpy()
        return class_map_counts(cls, labels_dev, self.n_classes)

    def _stage_eval_labels(self, eval_labels):
        lab = np.asarray(eval_labels)
        if lab.ndim == 4:
            lab = lab[..., 0]
        return torch.from_numpy(lab.astype(np.uint8)).to(self.device)

    def _run_view(self, v, n_views, model, sampler, volume, accum, w_v,
                  basis, plan, Mt, offsets, n_valid, want_side, keep=None):
        """One view on `volume`'s device: stack (shear plan, or the
        corner-packed gather when the view has no stack plan), U-Net
        `model`, remap (shear, grouped shear, or the gather remap) and
        accum += w_v * mapped, each in a span kept in `keep` (a list, or
        None). Returns the view's uint8 argmax (with want_side) or
        None."""
        stack_plan, (mode, group, r_plan, r_bounds) = plan
        fill = sampler.scaled_bg_value
        g0, g_step, o0, o_step = self._grid_params(offsets)
        self.remap_modes.append(mode if group is None else f"grouped:{group}")
        self._log(f"View {v + 1}/{n_views}: "
                  f"{'gather' if stack_plan is None else 'shear'} "
                  f"stack, remap {self.remap_modes[-1]}"
                  + ("" if volume.device == self.device
                     else f" (device {volume.device})"))
        with trace.span("predict.stack", device=volume.device, keep=keep):
            if stack_plan is None:
                stack = sample_plane_stack_packed(
                    volume, sampler.origin, sampler.spacing,
                    sampler.rot_mat, basis, offsets, self.span, self.dim,
                    fill, valid_shape=sampler.valid_shape)
            else:
                # Catmull-Rom forward passes keep the input sharp; bf16
                # passes halve the bandwidth (the U-Net computes in bf16)
                stack = shear_resample(volume, stack_plan[0], fill,
                                       method="cubic",
                                       compute_dtype=torch.bfloat16,
                                       exact_bounds=stack_plan[1])
        with trace.span("predict.unet", device=volume.device, keep=keep):
            pred = self._unet_stack(stack, model)
            del stack
        with trace.span("predict.remap", device=volume.device, keep=keep):
            if mode in ("gather", "gather-remap"):
                M, t = Mt
                side = accum_view_pred_affine(
                    pred, g0, g_step, o0, o_step, M, t, accum, w_v, n_valid,
                    want_argmax=want_side)
            else:
                mapped = self.shear_remap(pred, r_plan, r_bounds, group)
                side = (mapped.argmax(dim=-1).to(torch.uint8)
                        if want_side else None)
                # accum + w * mapped in float32, with no second f32 volume
                accum.addcmul_(mapped, w_v)
                del mapped
            del pred
        return side

    def _run_views(self, sampler, volume, bases, plans, ws, out_shape,
                   offsets, n_valid, Mts, want_side, crop, labels_dev):
        """The per-view loop on this predictor's device (`_run_view`).
        Returns (accum, per-view results)."""
        accum = torch.zeros(out_shape + (self.n_classes,),
                            dtype=torch.float32, device=self.device)
        per_view = []
        for v, plan in enumerate(plans):
            side = self._run_view(v, len(plans), self.model, sampler, volume,
                                  accum, ws[v], bases[v], plan, Mts[v],
                                  offsets, n_valid, want_side, self._stages)
            if want_side:
                per_view.append(self._per_view_result(side, crop,
                                                      labels_dev))
        return accum, per_view

    @torch.inference_mode()
    def predict_image(self, image, views, fusion_params=None,
                      n_planes="same+20", return_per_view=True,
                      return_probs=False, defer_fetch=False,
                      eval_labels=None):
        """Run all views over one image and fuse.

        Returns (fused, per_view) cropped to the image's true shape.
        `fused` is the uint8 argmax class map, or with return_probs the
        fused probabilities (softmax(accum + b) with learned fusion,
        accum / n_views without), as numpy; with defer_fetch a zero-arg
        callable returning it (the device work is already queued).
        `per_view` is a list of per-view uint8 class maps, or with
        eval_labels (host label volume) of (3, n_classes) int64 confusion
        counts against them (only those counts leave the device), or None
        when not return_per_view.

        Spans (`utils.trace`, request id the call's number): the root
        `predict.image`; `predict.plan` on the host; `predict.stage`,
        each view's `predict.stack`, `predict.unet` and `predict.remap`,
        and `predict.fuse` on the device, kept for `stage_ms`."""
        self._calls += 1
        with trace.span("predict.image", request=self._calls):
            return self._predict_image(image, views, fusion_params, n_planes,
                                       return_per_view, return_probs,
                                       defer_fetch, eval_labels)

    def _plan(self, image, views, fusion_params, n_planes):
        """predict_image's host planning: (offsets, n_valid, W, b, bases,
        Mts, plans), plans None where the gather path runs."""
        true_shape = tuple(int(s) for s in image.shape[:3])
        offsets, n_valid = self._prepare_offsets(image, n_planes)
        W, b = self._fusion_Wb(fusion_params, len(views))
        bases = [geometry.plane_basis(view, noise_sd=0.0) for view in views]
        Mts = [self._remap_transform(image, basis, true_shape)
               for basis in bases]
        plans = None
        if self.resampler in ("auto", "shear"):
            plans = self._plan_shear_views(image, bases, Mts, offsets,
                                           n_valid)
            if plans is None and self.resampler == "shear":
                raise ValueError(
                    "resampler='shear' requested but a view affine does not "
                    "factor within the memory guard; use 'auto' (falls back "
                    "to the exact gather path) or 'gather'")
        return offsets, n_valid, W, b, bases, Mts, plans

    def _predict_image(self, image, views, fusion_params, n_planes,
                       return_per_view, return_probs, defer_fetch,
                       eval_labels):
        sampler = image.interpolator
        true_shape = tuple(int(s) for s in image.shape[:3])
        n_views = len(views)
        with trace.span("predict.plan"):
            offsets, n_valid, W, b, bases, Mts, plans = self._plan(
                image, views, fusion_params, n_planes)
        labels_dev = (self._stage_eval_labels(eval_labels)
                      if return_per_view and eval_labels is not None
                      else None)

        dev = self.device
        self._stages = []
        self.remap_modes = []
        with trace.span("predict.stage", device=dev, keep=self._stages):
            volume = self._stage_volume(sampler, packed=plans is None)
        out_shape = tuple(int(s) for s in volume.shape[:3])
        ws = (torch.from_numpy(W) if W is not None
              else torch.ones((n_views, self.n_classes))).to(dev)
        crop = tuple(slice(0, s) for s in true_shape)
        if plans is None:  # the exact gather path for every view
            plans = [(None, ("gather", None, None, None))] * n_views
        accum, per_view = self._run_views(
            sampler, volume, bases, plans, ws, out_shape, offsets, n_valid,
            Mts, return_per_view, crop, labels_dev)
        del volume
        if labels_dev is not None:
            per_view = [c.cpu().numpy() for c in per_view]

        b_t = torch.from_numpy(b).to(dev)
        with trace.span("predict.fuse", device=dev, keep=self._stages):
            if return_probs:
                fused = (torch.softmax(accum + b_t, dim=-1)
                         if fusion_params is not None else accum / n_views)
                out = fused[crop]
            else:
                # argmax is invariant to softmax and to the sum-fusion 1/n
                # scaling, so bias + argmax is the fused class map
                out = (accum + b_t)[crop].argmax(dim=-1).to(torch.uint8)
            del accum
            if not defer_fetch:
                out = out.cpu().numpy()
        per_view = per_view if return_per_view else None
        if defer_fetch:
            return (lambda: out.cpu().numpy()), per_view
        return out, per_view

    # ------------------------------------------------ view-parallel path
    def _replica(self, device):
        """This predictor's model on `device`: the model itself on its own
        device, else a copy made once per device."""
        if device == self.device:
            return self.model
        if device not in self._replicas:
            self._replicas[device] = copy.deepcopy(self.model).to(device)
        return self._replicas[device]

    @torch.inference_mode()
    def predict_image_sharded(self, image, views, devices, fusion_params=None,
                              n_planes="same+20"):
        """View-parallel inference over `devices` (a list; an entry may
        repeat): view v runs on devices[v % n] through the same stack ->
        U-Net -> remap calls as predict_image, with one model replica and
        one copy of the staged volume per distinct device and one float32
        fusion accumulator per list entry; the accumulators are summed on
        devices[0], then bias and argmax. The views are queued from this
        thread with no synchronisation of their own: a view's small
        host-to-device copies wait only for its own device's earlier
        work, so separate cards overlap. Shear
        where every view factors within the memory guard (as in
        predict_image), else the exact gather path for every view.
        Returns the fused uint8 class map at the image's true shape."""
        devices = [torch.device(d) for d in devices]
        sampler = image.interpolator
        true_shape = tuple(int(s) for s in image.shape[:3])
        n_views = len(views)
        with trace.span("predict.plan"):
            offsets, n_valid, W, b, bases, Mts, plans = self._plan(
                image, views, fusion_params, n_planes)
        packed = plans is None
        if packed:
            plans = [(None, ("gather", None, None, None))] * n_views
        self.remap_modes = []
        n_use = min(len(devices), n_views)
        volumes = {devices[0]: self._stage_volume(sampler, packed,
                                                  devices[0])}
        for d in devices[1:n_use]:
            if d not in volumes:
                volumes[d] = volumes[devices[0]].to(d, non_blocking=True)
        out_shape = tuple(int(s) for s in volumes[devices[0]].shape[:3])
        ws = torch.from_numpy(W) if W is not None \
            else torch.ones((n_views, self.n_classes))
        ws = {d: ws.to(d) for d in volumes}
        accums = [torch.zeros(out_shape + (self.n_classes,),
                              dtype=torch.float32, device=d)
                  for d in devices[:n_use]]
        for v, plan in enumerate(plans):
            d = devices[v % n_use]
            with torch.cuda.device(d) if d.type == "cuda" else \
                    contextlib.nullcontext():
                self._run_view(v, n_views, self._replica(d), sampler,
                               volumes[d], accums[v % n_use], ws[d][v],
                               bases[v], plan, Mts[v], offsets, n_valid,
                               False)
        total = accums[0]
        for a in accums[1:]:
            total = total + a.to(devices[0], non_blocking=True)
        crop = tuple(slice(0, s) for s in true_shape)
        b_t = torch.from_numpy(b).to(devices[0])
        return (total + b_t)[crop].argmax(dim=-1).to(torch.uint8).cpu() \
            .numpy()

    # ------------------------------------------------- fusion training data
    def _views_mapped(self, image, views, n_planes):
        """Yield each view's mapped class probabilities, (X, Y, Z,
        n_classes) float32 on the device cropped to the image's true
        shape, by the exact gather path: corner-packed trilinear stack,
        U-Net (bf16 probabilities), nearest remap (the JAX package's
        predict_view with return_probs)."""
        sampler = image.interpolator
        volume = self._stage_volume(sampler, packed=True)
        out_shape = tuple(int(s) for s in volume.shape[:3])
        true_shape = tuple(int(s) for s in image.shape[:3])
        crop = tuple(slice(0, s) for s in true_shape)
        offsets, n_valid = self._prepare_offsets(image, n_planes)
        g0, g_step, o0, o_step = self._grid_params(offsets)
        for view in views:
            basis = geometry.plane_basis(view, noise_sd=0.0)
            M, t = self._remap_transform(image, basis, true_shape)
            stack = sample_plane_stack_packed(
                volume, sampler.origin, sampler.spacing, sampler.rot_mat,
                basis, offsets, self.span, self.dim, sampler.scaled_bg_value,
                valid_shape=sampler.valid_shape)
            pred = self._unet_stack(stack)
            del stack
            mapped = map_view_pred_affine(pred, g0, g_step, o0, o_step, M, t,
                                          out_shape, n_valid)
            del pred
            yield mapped[crop].float()

    @torch.inference_mode()
    def predict_views_mapped(self, image, views, n_planes="same+20"):
        """Per-view mapped probability volumes (n_views, X, Y, Z,
        n_classes) float32 on the host, at the image's true shape (the
        exact gather path)."""
        return np.stack([m.cpu().numpy() for m in
                         self._views_mapped(image, views, n_planes)])

    @torch.inference_mode()
    def predict_views_points(self, image, views, n_planes="same+20",
                             max_points=None, key=None):
        """Fusion-training points of one labelled image, left on the
        device: (points (n_pts, n_views, n_classes) float32, targets
        (n_pts,) int32). Each view's mapped volume (the exact gather path)
        is cropped and flattened on the device and the labels are staged
        once as uint8, so nothing volume-sized returns to the host.

        max_points: when the image has more voxels, keep a uniform random
        subset of that many, the first max_points of
        `prng.permutation(key, n_vox)` on this predictor's device (key
        PRNGKey(0) when None): the JAX package's subset for the same
        key."""
        true_shape = tuple(int(s) for s in image.shape[:3])
        n_vox = int(np.prod(true_shape))
        idx = None
        if max_points and n_vox > int(max_points):
            key = prng.PRNGKey(0) if key is None else key
            idx = prng.permutation(key, n_vox,
                                   device=self.device)[:int(max_points)]
        labels = np.asarray(image.labels).reshape(-1)
        tgt_dtype = np.uint8 if self.n_classes <= 256 else np.int32
        targets = torch.from_numpy(labels.astype(tgt_dtype)).to(self.device)
        if idx is not None:
            targets = targets[idx]
        points = torch.empty((targets.shape[0], len(views), self.n_classes),
                             dtype=torch.float32, device=self.device)
        for v, mapped in enumerate(self._views_mapped(image, views,
                                                      n_planes)):
            flat = mapped.reshape(-1, self.n_classes)
            points[:, v] = flat if idx is None else flat[idx]
            del mapped, flat
        return points, targets.to(torch.int32)


# ------------------------------------------------------- plane-stack helpers
def predict_volume(predict_fn, X, batch_size=8, axis=2):
    """predict_fn over a plane stack in chunks of batch_size planes (X: a
    tensor with the planes on `axis`); the outputs concatenated with the
    planes back on `axis`."""
    X = torch.movedim(torch.as_tensor(X), axis, 0)
    out = torch.cat([predict_fn(X[i:i + batch_size])
                     for i in range(0, X.shape[0], batch_size)], dim=0)
    return torch.movedim(out, 0, axis)


def map_real_space_pred(pred, grid, inv_basis, affine, true_shape,
                        method="nearest"):
    """A (d, d, P, C) prediction stack (a tensor) mapped onto the
    (X, Y, Z) voxel grid of an image with `affine`: (X, Y, Z, C) on
    pred's device. `grid` is the (real_axis, real_axis, offsets) triple
    of the view's plane grid."""
    real_axis, _, offsets = grid
    A = np.asarray(affine, np.float64)[:3, :3]
    center = A @ ((np.asarray(true_shape[:3]) - 1) / 2.0)
    inv_basis = np.asarray(inv_basis, np.float64)
    M = (inv_basis @ A).astype(np.float32)
    t = (-inv_basis @ center).astype(np.float32)
    return map_view_pred_affine(
        torch.as_tensor(pred), float(np.float32(real_axis[0])),
        float(np.float32(real_axis[1] - real_axis[0])),
        float(np.float32(offsets[0])),
        float(np.float32(offsets[1] - offsets[0])), M, t,
        tuple(int(s) for s in true_shape[:3]), len(offsets), method=method)


# ------------------------------------------------------------------ 3D paths
# Boxes or patches per U-Net call of the 3D paths (the training batch)
BOX_CHUNK = 16
# Request ids of pred_3D_iso's calls, for its spans
_BOX_CALLS = itertools.count(1)


def unet_predict_fn(model, device):
    """The predict_fn of the 3D paths: a channels-last batch (B, *spatial,
    C) -> float32 probabilities (B, *spatial, n_classes) of `model` (eval
    mode, on `device`), under inference mode."""
    @torch.inference_mode()
    def predict(x):
        return model(x.to(device).movedim(-1, 1)).movedim(1, -1).float()
    return predict


def _class_map_or_volume(v, want_argmax):
    """The uint8 argmax class map of a (X, Y, Z, C) tensor, or the tensor,
    fetched as numpy."""
    if want_argmax:
        return v.argmax(dim=-1).to(torch.uint8).cpu().numpy()
    return v.cpu().numpy()


def _coverage_fraction(v):
    """Fraction of voxels any box touched: not all channels close to 0
    (torch.isclose's defaults are jnp.isclose's), one scalar fetch."""
    untouched = torch.isclose(v, v.new_zeros(())).all(dim=-1)
    return float((~untouched).float().mean())


def pred_3D_iso(predict_fn, sequence, image, extra_boxes, min_coverage=None,
                logger=None, want_argmax=False):
    """Scanner-space box inference of the JAX package's `pred_3D_iso`:
    the base tiling of the image's scanner space, then `extra_boxes`
    random boxes (an int, or 'Nx' times the base count; each drawn as its
    placement, then its rotation, from np.random), then rounds of
    base/4 random boxes until the covered share reaches min_coverage.
    Each box is sampled from the staged volume (`sample_box_batch`), run
    through predict_fn in chunks and scatter-added onto its nearest
    voxels of a float32 (X, Y, Z, n_classes) accumulator on the
    sequence's device, boxes in order. Returns the un-normalised sums, or
    with want_argmax only their uint8 class map (the only transfer off
    the device).

    With the recorder on, each call is a `predict3d.image` span (a
    request of its own) holding per chunk the device spans
    `predict3d.gather` (the box sampling), `predict3d.unet` (predict_fn;
    counter `predict3d.boxes`) and `predict3d.scatter` (the scatter-add).
    """
    n_classes = sequence.n_classes
    dev = sequence.device
    sampler = image.interpolator
    true_shape = tuple(int(s) for s in image.shape[:3])
    pred_vol = torch.zeros(true_shape + (n_classes,), dtype=torch.float32,
                           device=dev)
    vol = sampler.device_volume_unpacked(dev, dtype=torch.float32)
    rot = sampler.device_rot(dev)
    valid = tuple(int(s) for s in sampler.valid_shape)
    real_box_dim, d = float(sequence.real_box_dim), sequence.sample_dim

    base_corners = np.asarray(sequence.base_placements(image), np.float32)
    total_base = len(base_corners)
    if isinstance(extra_boxes, str):
        total_extra = int(float(extra_boxes.rstrip("x")) * total_base)
    else:
        total_extra = int(extra_boxes)
    eye = np.eye(3, dtype=np.float32)

    def run_boxes(corners, rots, inv_rots, label):
        if logger:
            logger(f"   {len(corners)} {label} boxes in chunks of "
                   f"{BOX_CHUNK}", print_calling_method=False)
        for s in range(0, len(corners), BOX_CHUNK):
            sl = slice(s, s + BOX_CHUNK)
            with trace.span("predict3d.gather", device=dev):
                ims = sample_box_batch(vol, sampler.origin, sampler.spacing,
                                       rot, corners[sl], real_box_dim,
                                       rots[sl], d, sampler.scaled_bg_value,
                                       valid_shape=valid)
            with trace.span("predict3d.unet", device=dev):
                trace.count("predict3d.boxes", len(ims))
                preds = predict_fn(ims)
            with trace.span("predict3d.scatter", device=dev):
                scatter_box_pred(pred_vol, preds, corners[sl], real_box_dim,
                                 inv_rots[sl], rot, sampler.origin,
                                 sampler.spacing, d, true_shape)

    def draw_random(n):
        corners, rots, invs = [], [], []
        for _ in range(int(n)):
            corners.append(geometry.random_box_placement(
                image.real_shape, real_box_dim).astype(np.float32))
            rot_b = (geometry.random_box_rotation(sequence.noise_sd)
                     .astype(np.float32) if sequence.noise_sd else eye)
            rots.append(rot_b)
            invs.append(np.linalg.inv(
                rot_b.astype(np.float64)).astype(np.float32))
        return np.stack(corners), np.stack(rots), np.stack(invs)

    eyes = np.repeat(eye[None], total_base, axis=0)
    with trace.span("predict3d.image", request=next(_BOX_CALLS)):
        run_boxes(base_corners, eyes, eyes, "base")
        if total_extra:
            run_boxes(*draw_random(total_extra), "extra")
        if min_coverage:
            coverage = _coverage_fraction(pred_vol)
            while coverage < min_coverage:
                run_boxes(*draw_random(max(1, total_base // 4)), "coverage")
                coverage = _coverage_fraction(pred_vol)
        return _class_map_or_volume(pred_vol, want_argmax)


def predict_3D_patches(predict_fn, patches, image, n_extra=0, n_classes=None,
                       logger=None, want_argmax=False):
    """Voxel-space patch inference of the JAX package's
    `predict_3D_patches`: the base corners, then n_extra random corners
    (np.random), each patch cut from the staged volume, run through
    predict_fn in chunks and added onto its slice of a float32 recon on
    the patches' device, patches in order; returns the recon normalised
    to unit sum per voxel, or with want_argmax its uint8 class map. A
    volume smaller than a patch on some axis takes the host loop over
    `patches.get_patches_from` (center_expand padding), as in the JAX
    package."""
    i1, i2, i3 = (int(s) for s in image.shape[:3])
    n_classes = n_classes or patches.n_classes
    d = patches.dim
    dev = patches.device
    sampler = getattr(image, "interpolator", None)
    if min(i1, i2, i3) < d or sampler is None:
        recon = np.zeros((i1, i2, i3, n_classes), np.float32)
        for patch, (i, k, v), _ in patches.get_patches_from(image, n_extra):
            pred = predict_fn(torch.from_numpy(
                np.asarray(patch, np.float32)[None]))[0].cpu().numpy()
            recon[i:i + d, k:k + d, v:v + d] += pred[
                : min(d, i1 - i), : min(d, i2 - k), : min(d, i3 - v)]
        if want_argmax:
            return recon.argmax(-1).astype(np.uint8)
        return recon / np.maximum(recon.sum(-1, keepdims=True), 1e-8)

    corners = np.asarray(patches.base_corners(image), np.int64)
    if n_extra:
        extra = np.asarray([patches._random_corner(image.image.shape)
                            for _ in range(int(n_extra))], np.int64)
        corners = np.concatenate([corners, extra.reshape(-1, 3)])
    if logger:
        logger(f"   {len(corners)} patches in chunks of {BOX_CHUNK}")
    vol = sampler.device_volume_unpacked(dev, dtype=torch.float32)
    recon = torch.zeros((i1, i2, i3, n_classes), dtype=torch.float32,
                        device=dev)
    for s in range(0, len(corners), BOX_CHUNK):
        block = corners[s:s + BOX_CHUNK]
        preds = predict_fn(torch.stack([vol[a:a + d, b:b + d, c:c + d]
                                        for a, b, c in block]))
        for (a, b, c), pred in zip(block, preds):
            recon[a:a + d, b:b + d, c:c + d] += pred
    if not want_argmax:
        recon = recon / torch.clamp(recon.sum(dim=-1, keepdim=True),
                                    min=1e-8)
    return _class_map_or_volume(recon, want_argmax)


def predict_3D_patches_binary(predict_fn, patches, image, n_extra=0,
                              logger=None, threshold=0.20):
    """Binary vote recon of a one-output model (the JAX package's
    `predict_3D_patches_binary`): per voxel the patches voting > 0.5 and
    the rest; 1 where the first exceed threshold x all votes. Host
    loop."""
    i1, i2, i3 = image.shape[:3]
    d = patches.dim
    recon = np.zeros((i1, i2, i3, 2), np.uint32)
    for patch, (i, k, v), _ in patches.get_patches_from(image, n_extra):
        pred = predict_fn(torch.from_numpy(
            np.asarray(patch, np.float32)[None]))[0].cpu().numpy().squeeze()
        mask = pred > 0.5
        sl = np.s_[i:i + d, k:k + d, v:v + d]
        recon[sl + (0,)] += ~mask[: i1 - i, : i2 - k, : i3 - v]
        recon[sl + (1,)] += mask[: i1 - i, : i2 - k, : i3 - v]
    total = recon.sum(-1)
    return (recon[..., 1] > threshold * total).astype(np.uint8)


# ------------------------------------------------------------- convenience
def predict_single(image, model, hparams, views=None, logger=None,
                   device=None):
    """One ImagePair's predictions under a project's hparams (the JAX
    package's `predict_single`), on `device` (the card by default, which
    raises without one):

    - intrp_style iso_live: every view's mapped probabilities,
      (n_views, X, Y, Z, n_classes) float32 on the host, by
      `MultiViewPredictor.predict_views_mapped` (the exact gather path);
      views from <project>/views.npz when None;
    - iso_live_3d: the un-normalised box sums (X, Y, Z, n_classes)
      float32 of `pred_3D_iso` with 3x extra boxes, over a sequence of
      this one image.

    The torch model holds its own weights, so the JAX form's `variables`
    argument is gone: a call in that form, (image, model, variables,
    hparams), raises a TypeError naming it. The model is moved to the
    device and put in eval mode. Another intrp_style raises the JAX
    package's ValueError."""
    if not hasattr(hparams, "get_from_anywhere"):
        raise TypeError(
            "predict_single takes (image, model, hparams, views=None, "
            "logger=None, device=None): the torch model holds its own "
            "weights, so the JAX package's `variables` argument is gone; "
            f"got {type(hparams).__name__} where the hparams go")
    mode = hparams["fit"]["intrp_style"].lower()
    if mode not in ("iso_live", "iso_live_3d"):
        raise ValueError(f"predict_single supports iso_live modes, got {mode}")
    device = resolve_device(device)
    model = model.to(device).eval()
    image.set_bg_value(hparams.get_from_anywhere("bg_value"))
    image.set_scaler(hparams.get_from_anywhere("scaler"))
    if mode == "iso_live":
        if views is None:
            views = np.load(os.path.join(hparams.project_path,
                                         "views.npz"))["arr_0"]
        predictor = MultiViewPredictor(
            model, sample_dim=hparams["build"]["dim"],
            real_space_span=hparams["fit"]["real_space_span"],
            n_classes=hparams["build"]["n_classes"], device=device,
            logger=logger)
        with image.loaded_in_context():
            return predictor.predict_views_mapped(image, views)
    from multiplanarunet_tpu_torch.sequences.utils import get_sequence

    seq = get_sequence(
        data_queue=_SingleImageQueue(image), is_validation=True,
        logger=logger, dim=hparams["build"]["dim"],
        n_classes=hparams["build"]["n_classes"], no_log=True, device=device,
        **hparams["fit"])
    with image.loaded_in_context():
        return pred_3D_iso(unet_predict_fn(model, device), seq, image,
                           extra_boxes="3x", min_coverage=None)


class _SingleImageQueue:
    """A queue over one image: every draw is that image."""

    def __init__(self, image):
        self.image = image

    @contextlib.contextmanager
    def get_random_image(self):
        yield self.image
