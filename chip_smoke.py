#!/usr/bin/env python3
"""Smoke run of the PyTorch port (multiplanarunet_tpu_torch) on one NVIDIA
GPU: builds the CUDA kernels from csrc/ (one nvcc per source, in
parallel; no instantiation may keep a stack frame or spill), holds the
shear pass against its plain PyTorch version on every specialisation and
the threefry2x32 draws against theirs, bit for bit, at the training
paths' sizes (`phase_threefry`: Elastic2D and Elastic3D batches, a 256^3
permutation, the full-width 2D init; with one Elastic2D batch on the card
against the CPU from one key), checks the predictor's geometry with a one-hot
oracle (shear, gather and auto's fallback), then drives fused multi-view
inference at full width (U-Net complexity_factor 2, depth 4, dim 256, 7
classes; 6 views + learned fusion over 256^3 volumes, bench.py's
configuration) and times it, and requires the same class map with the
plain pass in the kernel's place. The predictor runs the U-Net in the JAX
predictor's form (the dilated decoder, filters zero-padded to multiples
of 8); `phase_unet_variants` holds every form against the plain one in
float32, times each in bf16, loads a lane-padded checkpoint through
build_model, and runs predict-256 in the plain form against the
default. It times the kernel's 6-pass plans
beside their HBM bound, the plain version and a dense-W torch.bmm library
arm. Then: the channel-grouped remap against the
ungrouped one, the gather resampler on a full-width 256^3 volume, uint8
staging, `mp predict` end to end on a two-image NIfTI project, one 512^3
volume with the kernel held against its plain version at that volume's
largest shapes, the configuration surface the JAX package takes by name
(`phase_config_surface`: eighteen more activations on one decoder-sized
activation against the host, `mp predict` of a 128^3 subject through a
PowerTransformer + mish project against predict_image, the new scalers'
host seconds, and centered RMSprop and bf16 optimizer moments at
train-256's step, each update against the host's), and training: `mp
train` (a subprocess, through the mp
entry point) of the same model on a project that the port's `mp
init_project` makes from its MultiPlanar preset, over 3 + 1 structured
256^3 subjects (2 epochs of 20 steps of 16, Elastic2D) on the pooled
sampler, a float32 step on the card against the host, the bf16 step
against the float32 one, a 50-step overfit, the step, sampler and
validation times; the pooled sampler against the per-image path in
alternating rounds, its parts, its batches on the card against the CPU's
and its pool's bytes; the pooled path with LRU eviction over a
LimitationQueue, and `mp train --max_loaded_images 2` (a subprocess, the
per-image path over a LimitationQueue). Then the callbacks and tools: `mp
train` (a subprocess, 2 epochs of 10 steps) of a copy of that project
with the QuantileTransformer scaler and every callback configurable by
name (the Profiler's trace of epoch 1 read for its CUDA kernels),
Trainer.predict_batch against the eval-mode forward, ValDiceScores,
DeviceMonitor and describe_devices, the analytic U-Net FLOPs against the
hook count, the scaler's host seconds per 256^3 subject, `mp predict` of
the val subject on the trained copy, `mp trim_channels`, and `mp
export_weights` -> `mp convert_weights` (or, without h5py, the error
that names it). Then the 3D path at the 3D
preset's full width (UNet3D cf 1, depth 3, 64 filters, 64^3 boxes, batch
16): a project from `mp init_project --model 3D` over the same subjects
(the Auditor fills dim and real_box_dim), `mp train` (a subprocess, 2
epochs of 10 steps, Elastic3D, the pooled box sampler), the step and
sampler times, a float32 step and forward on the card against the host,
a pooled box batch card vs CPU, `pred_3D_iso` and `predict_3D_patches`
with the one-hot oracle, and `mp predict_3D` (a subprocess) on the 256^3
val subject. Then multi-task training at the MultiTask preset's full
width (the shared encoder and two heads, cf 2, depth 4, bf16, batch 16
per task): a project from `mp init_project --model MultiTask` with task 1
on the same subjects and task 2 on 3 + 1 structured 192^3 subjects of 4
classes, `mp train` (a subprocess, 2 epochs of 10 steps, then one more
of 2 steps with --continue_training), the parameter count against the layer shapes,
the step's times, TFLOP/s, peak memory and device-busy share, a float32
multi-task step on the card against the host, and `mp branch
--copy_weights` (a subprocess). Last, the
workflow on the trained project: `mp train_fusion` (a subprocess), the
fused probabilities of its points path against predict_image's with the
learned weights, `mp predict` with the learned fusion and `mp summary`
(through its entry point) over its results. Then multi-device and multi-process execution on the
one card (`phase_multi_device`): two ranks sharing cuda:0 on a gloo group,
started from the library layer (DistributedDataParallel and global-batch
BatchNorm at full width, bf16, global batch 16: the loss stream and a
parameter checksum bit-equal across the ranks, a float32 two-rank step
against the one-process step), `mp train` as a 1-rank NCCL group, `mp
predict` as two processes on cuda:0 against the one-process results,
predict_image_sharded over [cuda:0, cuda:0] against predict_image, `mp
train_fusion` as two processes against the workflow's one-process run,
the named error of `mp train --num_devices 2` on one card, and the
library entry points that place data or start a group on the card when
given no device. Each path's shear-pass launches are
counted from 0 just before it and gated against what its plans and remap
modes say (the training, 3D, multi-task and fusion-training paths
themselves launch none; the two-process `mp predict` reads its launches
from the ranks' logs). Each phase's threefry launches are counted from 0
at its start, and each `mp train` and `mp train_fusion` reports its own
in its log: every one of them, and the in-process training, 3D and
multi-task checks, must have drawn through the kernel.

The script aims to finish within 600 s on an H100, half its 1200 s
limit, and prints each phase's host seconds and their sum on a line
before the kernels line. nvcc builds the kernel in a thread beside the
main path's set-up; the fused-probability check takes the main path's
class map of its first volume; the full-width models of the step checks
are copies of one initialisation per model (glorot_model, drawn on the
card). Some
earlier paths run at a cut depth or scale, each keeping its gate:

- U-Net forms: predict-256 in the naive form runs twice on the main
  path's second volume, against the main path's own runs in the default
  form (their times and that volume's class map), not in four runs of
  its own; the bf16 forward timing takes FORMS_REPS (6) rounds after
  FORMS_WARMUP (2), not 12 after 3;
- training: the overfit check OVERFIT_STEPS (20) steps, not 50; the
  sampler A/B AB_ROUNDS (3) rounds, not 5;
- callbacks and tools: the scaler's host seconds from SCALER_REPS (1)
  repetition, not 3;
- config surface (a): the float32 comparison with the host on the first
  CS_ACT_CHECK_PLANES (4) of the 46 planes; the timing on all 46;
- config surface (b) and (c): one structured CS_SUBJECT^3 (128^3)
  subject, not 256^3 (the PowerTransformer's fit grows with the voxels);
  its launches come from its own plans (72, as at 256^3), its class map
  is held against predict_image in every voxel, and box-cox still fits
  a 64^3 subsample;
- workflow: `mp train_fusion` takes 2^20 points per image (the script's
  default is 2^22), and `mp summary`, a host-only tool, runs through its
  entry point instead of a subprocess;
- multi-device: the two-process `mp train_fusion` takes the workflow's
  fusion set (linked in its order) and arguments, and is held against
  the workflow's one-process fit within 1e-6: no one-process run of its
  own.

Run from the repository root with no arguments:

    python3 chip_smoke.py

(The data-parallel phase starts this script again as its ranks, with
DP_WORKER_FLAG and an output folder.)

Any failed check raises and the process exits non-zero. Without a CUDA
device it raises before printing any result. The second-to-last line of
standard output is a JSON object describing the kernels; the last is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import copy
import functools
import io
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch
from torch import nn

from multiplanarunet_tpu_torch._device import require_cuda
from multiplanarunet_tpu_torch.augmentation.augmenters import Elastic2D
from multiplanarunet_tpu_torch.bin import mp as port_mp
from multiplanarunet_tpu_torch.bin import train_fusion as port_train_fusion
from multiplanarunet_tpu_torch.callbacks.validation import Validation
from multiplanarunet_tpu_torch.evaluate.losses import (
    SparseCategoricalCrossentropy,
)
from multiplanarunet_tpu_torch.evaluate.metrics import (
    METRICS,
    dice_from_counts,
)
from multiplanarunet_tpu_torch.hyperparameters.hparams import YAMLHParams
from multiplanarunet_tpu_torch.hyperparameters.yaml_reader import safe_load
from multiplanarunet_tpu_torch.image.image_pair import ImagePair
from multiplanarunet_tpu_torch.image.queue.queues import LimitationQueue
from multiplanarunet_tpu_torch.image.volume_sampler import VolumeSampler
from multiplanarunet_tpu_torch.io import nifti
from multiplanarunet_tpu_torch.logging.log_results import (
    ResultTable,
    load_result_dicts,
)
from multiplanarunet_tpu_torch.logging.loggers import ScreenLogger
from multiplanarunet_tpu_torch.models import checkpoint
from multiplanarunet_tpu_torch.models.model_init import (
    build_model,
    load_unet_weights,
)
from multiplanarunet_tpu_torch.models.multitask_unet import MultiTaskUNet2D
from multiplanarunet_tpu_torch.models import unet as unet_module
from multiplanarunet_tpu_torch.models.unet import UNet, glorot_init
from multiplanarunet_tpu_torch.models.unet3d import UNet3D
from multiplanarunet_tpu_torch.ops import _build, elastic, geometry, prng
from multiplanarunet_tpu_torch.ops.interp import (
    map_view_pred_to_voxels,
    sample_plane_stack_packed,
)
from multiplanarunet_tpu_torch.ops.shear import (
    shear_resample,
    shear_resample_np,
)
from multiplanarunet_tpu_torch.ops import shear as shear_module
from multiplanarunet_tpu_torch.ops.shear_pass import (
    pass_positions,
    shear_pass,
    shear_pass_reference,
    tap_parts,
    tile_plan,
)
from multiplanarunet_tpu_torch.ops.shear_plan import (
    _Op,
    plan_affine_resample,
    plan_stage_bytes,
)
from multiplanarunet_tpu_torch.preprocessing.data_preparation_funcs import (
    prepare_for_3d_unet,
    prepare_for_multi_task_2d,
    prepare_for_multi_view_unet,
)
from multiplanarunet_tpu_torch.sequences import multi_planar
from multiplanarunet_tpu_torch.sequences.iso_3d import (
    IsotrophicLiveViewSequence3D,
)
from multiplanarunet_tpu_torch.sequences.patches_3d import PatchSequence3D
from multiplanarunet_tpu_torch.sequences.utils import get_sequence
from multiplanarunet_tpu_torch.train.train_step import (
    MultiTaskTrainStep,
    TrainStep,
)
from multiplanarunet_tpu_torch.train.trainer import Trainer
from multiplanarunet_tpu_torch.train.utils import init_optimizer
from multiplanarunet_tpu_torch.utils.conv_arithmetics import (
    unet_forward_flops,
)
from multiplanarunet_tpu_torch.utils.fusion import fuse_and_predict
from multiplanarunet_tpu_torch.utils.fusion.fuse_and_predict import (
    MultiViewPredictor,
    class_map_counts,
    map_real_space_pred,
    pred_3D_iso,
    predict_3D_patches,
    predict_single,
    unet_predict_fn,
)
from multiplanarunet_tpu_torch.utils.utils import get_best_model

# Kernel vs plain version, same inputs on the card. Both compute the same
# float32 positions and tap weights in the same order and sum the taps in
# float32 in the same order, so they agree bit for bit; the tolerances
# leave room only for a differently rounded position: 1e-5 in float32
# (unit-range data) and one bf16 ulp of the unit range (2^-7) in bf16.
TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
# The full-width main path (bench.py)
DIM, N_CLASSES, N_CHANNELS, DEPTH, CF, N_VIEWS = 256, 7, 1, 4, 2, 6
N_VOLUMES = 3
# The Liver-scale stress volume of the last phase
DIM_LARGE = 512
# Elements past which a tensor needs 64-bit indexing: the 512^3 volume's
# largest remap stage must pass it for its kernel check to test that
INDEX_32_LIMIT = 2 ** 31
# The mp predict project: the same model configuration as the main path,
# as `mp init_project` + the Auditor would write it for 256^3 volumes at
# 1 mm (@DATA@ is replaced by the data folder)
PROJECT_YAML = """\
# train_hparams.yaml of a multi-planar 2D U-Net project
__CB_es: &ES
  nickname: "es"
  class_name: "EarlyStopping"
  kwargs: {monitor: 'val_dice', min_delta: 0, patience: 15, verbose: 1, mode: 'max'}

test_data: &TESTDATA
  base_dir: @DATA@
  img_subdir: images
  label_subdir: labels
  bg_class: 0

build: &BUILD
  model_class_name: "UNet"
  n_classes: @N_CLASSES@
  n_channels: @N_CHANNELS@
  dim: @DIM@
  complexity_factor: @CF@
  out_activation: "softmax"
  l1_reg: False
  l2_reg: False
  biased_output_layer: True
  depth: @DEPTH@

fit: &FIT
  views: @N_VIEWS@
  noise_sd: 0.1
  real_space_span: @SPAN@
  optimizer_kwargs: {lr: 5.0e-05, decay: 0.0, beta_1: 0.9, beta_2: 0.999, epsilon: 1.0e-8}
  mixed_precision: True
  bg_value: 1pct
  scaler: "RobustScaler"
  callbacks: [*ES]
"""


def log(msg=""):
    print(msg, flush=True)


class Image:
    """Minimal ImagePair stand-in: shape, affine, physical extent and the
    port's sampler, in predict mode (no labels)."""

    predict_mode = True
    bg_class = 0

    def __init__(self, volume, affine):
        self.shape = volume.shape
        self.affine = affine
        self.interpolator = VolumeSampler(volume, affine, bg_value=0.0)

    @property
    def real_shape(self):
        return (np.asarray(self.shape[:3])
                * np.linalg.norm(np.asarray(self.affine)[:3, :3], axis=0))


class OneHotOracle(nn.Module):
    """'Model' returning one_hot(round(input intensity)): fed a label
    volume as the image, the pipeline must reconstruct the labels."""

    def __init__(self, n_classes):
        super().__init__()
        self.n_classes = n_classes

    def forward(self, x):
        cls = torch.clamp(torch.round(x[:, 0].float()), 0, self.n_classes - 1)
        onehot = nn.functional.one_hot(cls.long(), self.n_classes)
        return onehot.movedim(-1, 1).float()


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over reps runs, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# The first file written for each argument tuple of jax_format_unet_weights
# (later calls copy it: the draws take about a second at full width)
_WRITTEN_WEIGHTS = {}


def jax_format_unet_weights(path, n_classes, n_channels, depth, cf, seed,
                            init_filters=64, ndim=2):
    """Write a UNet (ndim 2) or UNet3D (ndim 3) checkpoint in the JAX
    package's .npz format from numpy alone: flax key names, HWIO (DHWIO)
    kernels drawn glorot-uniform from a seed, zero biases, BN scale 1 /
    bias 0 / mean 0 / var 1."""
    key = (n_classes, n_channels, depth, cf, seed, init_filters, ndim)
    first = _WRITTEN_WEIGHTS.get(key)
    if first is not None and first.is_file():
        if first != Path(path):
            shutil.copyfile(first, path)
        return
    _WRITTEN_WEIGHTS[key] = Path(path)
    rng = np.random.RandomState(seed)
    entries = {}

    def conv(name, k, cin, cout):
        lim = np.sqrt(6.0 / (k ** ndim * (cin + cout)))
        entries[f"params/{name}/kernel"] = rng.uniform(
            -lim, lim, (k,) * ndim + (cin, cout)).astype(np.float32)
        entries[f"params/{name}/bias"] = np.zeros(cout, np.float32)

    def bn(name, c):
        entries[f"params/{name}/scale"] = np.ones(c, np.float32)
        entries[f"params/{name}/bias"] = np.zeros(c, np.float32)
        entries[f"batch_stats/{name}/mean"] = np.zeros(c, np.float32)
        entries[f"batch_stats/{name}/var"] = np.ones(c, np.float32)

    def block(name, cin, f):
        conv(f"{name}/conv1", 3, cin, f)
        conv(f"{name}/conv2", 3, f, f)
        bn(f"{name}/bn", f)

    s = float(np.sqrt(cf))
    cin, filters = n_channels, init_filters
    for i in range(depth):
        block(f"encoder_L{i}", cin, int(filters * s))
        cin, filters = int(filters * s), filters * 2
    block("bottom", cin, int(filters * s))
    cin = int(filters * s)
    for i in range(depth):
        filters //= 2
        f = int(filters * s)
        conv(f"decoder_L{i}_conv_up", 2, cin, f)
        bn(f"decoder_L{i}_bn_up", f)
        block(f"decoder_L{i}", 2 * f, f)
        cin = f
    conv("out_conv", 1, cin, n_classes)
    np.savez(path, **entries)


def unet_flops_per_plane(model, dev, planes=None):
    """Forward FLOPs of one DIM x DIM plane (or of `planes`, the model's
    input: one plane per task for a multi-task model): 2 * MACs of every
    convolution, counted with forward hooks."""
    flops = []

    def hook(mod, _, out):
        kh, kw = mod.kernel_size
        flops.append(2 * out.shape[2] * out.shape[3] * mod.out_channels
                     * mod.in_channels * kh * kw)

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, nn.Conv2d)]
    with torch.inference_mode():
        model(torch.zeros(1, N_CHANNELS, DIM, DIM, device=dev)
              if planes is None else planes)
    for h in hooks:
        h.remove()
    return sum(flops)


def plan_bytes(plan, channels, itemsize=2):
    """Bytes each pass must at least move (read its input stage once,
    write its output stage once), summed over the plan."""
    sizes = [float(np.prod([e for (_, e) in st])) for st in plan.stages]
    return sum(a + b for a, b in zip(sizes, sizes[1:])) * channels * itemsize


def random_affine(rng):
    Q, _ = np.linalg.qr(rng.randn(3, 3))
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    return Q @ np.diag(1.0 + (rng.rand(3) * 0.8 - 0.3))


def compare_pass(shape, op, method, dtype, gen, covered=None, offset=0):
    """Feed one pass a random input (drawn on the card from `gen`, placed
    `offset` elements past an aligned address) through the kernel, all
    channels at once, and through the plain version one channel at a time
    (a pass treats each channel alone, and one channel of a 512^3 stage
    keeps the plain version's float32 temporaries small); returns the max
    abs difference. `covered` collects the kernel specialisations run."""
    n = int(np.prod(shape))
    A = torch.rand(n + offset, generator=gen, device=gen.device).to(dtype)
    A = A[offset:].view(shape)
    if covered is not None:
        aligned = A.data_ptr() % 16 == 0
        covered.add((op.m, op.q, method, dtype,
                     tile_plan(shape, op, method, dtype, aligned).ep))
    got = shear_pass(A, op, method)
    err = 0.0
    for c in range(shape[3]):
        want = shear_pass_reference(A[..., c:c + 1].contiguous(), op, method)
        got_c = got[..., c].float()
        if not torch.isfinite(got_c).all():
            raise AssertionError("kernel output holds non-finite values")
        err = max(err, (got_c - want[..., 0].float()).abs().max().item())
        del want, got_c
    if err > TOL[dtype]:
        raise AssertionError(f"kernel vs plain: max abs err {err} > "
                             f"{TOL[dtype]} ({method}, {dtype}, m={op.m}, "
                             f"q={op.q}, shape {shape})")
    return err


def compare_plan_passes(plan, method, channels, dtype, gen, covered=None):
    """compare_pass over every pass of `plan`; returns the max abs
    difference."""
    return max(compare_pass(tuple(ext for (_, ext) in plan.stages[i])
                            + (channels,), op, method, dtype, gen, covered)
               for i, op in enumerate(plan.ops))


def q_none_ops():
    """One pass per axis with no q term: (stage shape without C, op)."""
    out = []
    for m in range(3):
        op = _Op(m, None, -1.17 + 0.4 * m, 0.0)
        op.gamma, op.in_lo, op.in_extent = 3.3, 0, 40 + m
        op.out_lo, op.out_extent, op.q_lo = -2, 36 + 5 * m, 0
        shape = [31, 29, 27]
        shape[m] = op.in_extent
        out.append((tuple(shape), op))
    return out


def view_plans(predictor, img, views):
    """Every view's shear plans for `img`, as predict_image plans them."""
    true_shape = tuple(img.shape[:3])
    offsets, n_valid = predictor._prepare_offsets(img, "same+20")
    bases = [geometry.plane_basis(v) for v in views]
    Mts = [predictor._remap_transform(img, b, true_shape) for b in bases]
    return predictor._plan_shear_views(img, bases, Mts, offsets, n_valid)


def expected_launches(plans, modes):
    """Shear-pass launches of one predict_image over views with these
    plans and remap modes: each pass of a view's stack plan, and each pass
    of its remap plan once per channel group (none for a gather remap)."""
    n = 0
    for ((s_plan, _), (_, _, r_plan, _)), mode in zip(plans, modes):
        n += len(s_plan.ops)
        if mode == "shear":
            n += len(r_plan.ops)
        elif mode.startswith("grouped:"):
            group = int(mode.split(":")[1])
            n += -(-N_CLASSES // group) * len(r_plan.ops)
    return n


def phase_environment():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")
    return card


def phase_kernel_build(build):
    """The kernel libraries from `build` (a future of _build.kernels(),
    started beside the main path's set-up, which needs no kernel): their
    build time and the ptxas report, gated."""
    k = build.result()
    log(f"kernel libraries {[p.name for p in k.paths.values()]}: built in "
        f"{k.build_seconds:.2f} s (one nvcc per source, in parallel)")
    # ptxas -v: per function "N bytes stack frame, N bytes spill stores, N
    # bytes spill loads", then "Used N registers"; every instantiation must
    # keep no stack frame and spill nothing
    frames = [[int(w) for w in line.split() if w.isdigit()]
              for line in k.log.splitlines() if "bytes stack frame" in line]
    regs = [int(line.split("Used")[1].split()[0])
            for line in k.log.splitlines() if "registers" in line]
    worst = [max(f[i] for f in frames) for i in range(3)]
    log(f"ptxas: {len(frames)} functions, {len(regs)} register reports "
        f"(max {max(regs)} registers); max stack frame {worst[0]} bytes, "
        f"spill stores {worst[1]} bytes, spill loads {worst[2]} bytes")
    if not frames or any(worst):
        for line in k.log.splitlines():
            if ("stack frame" in line or "Function properties" in line
                    or "registers" in line):
                log(f"  ptxas: {line.strip()}")
        raise AssertionError("a kernel instantiation has a stack frame or "
                             "spills")


def phase_kernel_vs_plain(dev, main_plans):
    """The kernel against its plain version on every specialisation: the
    six (m, q) layouts of random plans and q = none on each axis, linear
    and cubic, float32 and bf16, C in {2, 3, 5, 8} (16-byte vectors, the
    two-channel form and the scalar form), stages with a ragged last tile,
    an input 2 elements past an aligned address (the scalar form); then
    every pass of the main path's view plans."""
    rng = np.random.RandomState(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0
    covered = set()
    for trial, (src, out) in enumerate((((48, 44, 40), (46, 42, 38)),
                                        ((150, 140, 136), (146, 144, 138)),
                                        ((48, 44, 40), (46, 42, 38)))):
        N = random_affine(rng)
        c = np.asarray(src) / 2.0 - N @ (np.asarray(out) / 2.0)
        plan = plan_affine_resample(N, c, src, out)
        for dtype in (torch.float32, torch.bfloat16):
            for method in ("linear", "cubic"):
                for ch in (2, 3, 5, 8):
                    e = compare_plan_passes(plan, method, ch, dtype, gen,
                                            covered)
                    worst = max(worst, e)
                log(f"random plan {trial} {src} -> {out} {method:6s} "
                    f"{str(dtype):14s} C=2,3,5,8 max abs err {worst:.3g} "
                    f"(tol {TOL[dtype]:.3g})")
    for shape, op in q_none_ops():
        for dtype in (torch.float32, torch.bfloat16):
            for method in ("linear", "cubic"):
                for ch in (2, 3, 8):
                    worst = max(worst, compare_pass(shape + (ch,), op, method,
                                                    dtype, gen, covered))
    for offset in (2, 0):
        s_plan = main_plans[0][0][0]
        worst = max(worst, compare_pass(
            tuple(e for (_, e) in s_plan.stages[0]) + (2,), s_plan.ops[0],
            "cubic", torch.bfloat16, gen, covered, offset=offset))
    layouts = {(m, q) for (m, q, *_) in covered}
    eps = sorted({(str(d), ep) for (*_, d, ep) in covered})
    log(f"kernel specialisations run against the plain version: "
        f"{len(covered)} (m, q, taps, dtype, EP) combinations over layouts "
        f"{sorted(layouts, key=str)}, (dtype, EP) {eps}; max abs err "
        f"{worst:.3g}")
    if len(layouts) != 9 or len(eps) != 6:
        raise AssertionError(f"layout coverage: {layouts}, {eps}")
    for v, ((s_plan, _), (_, _, r_plan, _)) in enumerate(main_plans):
        e_s = compare_plan_passes(s_plan, "cubic", N_CHANNELS + 1,
                                  torch.bfloat16, gen)
        e_r = compare_plan_passes(r_plan, "linear", N_CLASSES + 1,
                                  torch.bfloat16, gen)
        log(f"main-path view {v}: stack passes (cubic, C=2) max abs err "
            f"{e_s:.3g}, remap passes (linear, C=8) {e_r:.3g} "
            f"(bf16, tol {TOL[torch.bfloat16]:.3g})")
        worst = max(worst, e_s, e_r)

    # A whole shear_resample: kernel on the card vs plain version on the
    # host, f32 passes and bf16 passes with f32 out
    N = random_affine(rng)
    c = np.array([32.0, 30.0, 31.0]) - N @ np.array([30.0, 31.0, 29.0])
    plan = plan_affine_resample(N, c, (64, 64, 64), (60, 62, 58))
    src = rng.rand(64, 64, 64, 3).astype(np.float32)
    fill = np.array([0.5, -1.0, 2.0], np.float32)
    for method, dtype in (("cubic", torch.float32),
                          ("linear", torch.bfloat16)):
        kw = dict(method=method, compute_dtype=dtype,
                  out_dtype=torch.float32, exact_bounds=(N, c))
        got = shear_resample(torch.from_numpy(src).to(dev), plan, fill, **kw)
        want = shear_resample(torch.from_numpy(src), plan, fill, **kw)
        e = (got.cpu() - want).abs().max().item()
        log(f"shear_resample 64^3 {method} {dtype} passes: card kernel vs "
            f"host plain max abs err {e:.3g} (tol {TOL[dtype]:.3g})")
        if e > TOL[dtype]:
            raise AssertionError(f"shear_resample kernel vs plain {e}")
        worst = max(worst, e)
    return worst


# ------------------------------------------------------------ threefry2x32
# The card's int32 rate, for the threefry kernel's bound: 64 int32 lanes
# per SM (NVIDIA's Hopper architecture white paper) x 132 SMs x 1.98 GHz
# (the H100 SXM's boost clock)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int32 operations per value of csrc/threefry.cu: the counter split and
# the two first key adds (3), 20 rounds of add, funnel shift and xor (60),
# 5 key injections of two adds (10) and the closing xor (1); the uniform
# adds a shift and an or (its float steps run on the float32 pipe)
THREEFRY_OPS = {prng.BITS: 74, prng.UNIFORM: 76}
# An Elastic2D batch on the card against the CPU from one key: the fields
# agree bit for bit, the 129-tap blur sums in another order (float32,
# relative error below 129 * 2^-24 of the field's absolute sum, which at
# alpha 450 bounds the displacement's error by 3.5e-3 pixel), and a
# unit-range white-noise image moves by at most that; a label flips only
# where a fraction lies that close to the nearest-neighbour tie at 0.5
ELASTIC_CARD_TOL, ELASTIC_CARD_SHARE = 4e-3, 0.999


def threefry_bound_ms(n, mode):
    """The least milliseconds the card could take for n draws: the larger
    of the int32 operations over the int32 rate and the 4 bytes written
    per value over HBM's rate."""
    return max(n * THREEFRY_OPS[mode] / INT32_OPS_PER_S,
               4 * n / HBM_BYTES_PER_S) * 1e3


def threefry_cases():
    """The draws of the training paths at their full sizes, as (name, [(key,
    shape, mode, scale)], permuted n or None): Elastic2D's two fields of a
    train-256 batch, Elastic3D's three of a train3d-64 batch, the
    permutation of a 256^3 volume's voxels (--max_points_per_image: 3
    rounds of 2^24 sort keys) and the 2D model's glorot init (cf 2, depth
    4: every kernel in flax's shape with its scope's key and scale)."""
    key = prng.fold_in(prng.PRNGKey(7), 1)
    with torch.device("meta"):
        model = UNet(N_CLASSES, N_CHANNELS, DEPTH, CF)
    init = [(unet_module.scope_key(prng.PRNGKey(0), path[:-1], 1), shape,
             prng.UNIFORM, unet_module.glorot_scale(shape))
            for _, path, shape in checkpoint.flax_variables(model)
            if path[-1] == "kernel"]
    n_perm = DIM ** 3
    perm_keys = []
    pkey = prng.PRNGKey(1000)
    for _ in range(prng.num_shuffle_rounds(n_perm)):
        pkey, sub = prng.split(pkey)
        perm_keys.append((sub, (n_perm,), prng.BITS, 1.0))
    return [
        (f"Elastic2D, train-256 batch ({BATCH} x {DIM}^2 x 2)",
         [(k, (BATCH, DIM, DIM), prng.UNIFORM, 1.0)
          for k in prng.split(key)], None),
        (f"Elastic3D, train3d-64 batch ({BATCH} x {DIM_3D}^3 x 3)",
         [(k, (BATCH,) + (DIM_3D,) * 3, prng.UNIFORM, 1.0)
          for k in prng.split(key, 3)], None),
        (f"permutation of {DIM}^3 voxels ({len(perm_keys)} rounds)",
         perm_keys, n_perm),
        (f"2D init (cf {CF:g}, depth {DEPTH})", init, None),
    ]


def _draw_all(draws, dev, fn):
    """fn's draws of every (key, shape, mode, scale), flat, in order."""
    out = []
    for key, shape, mode, scale in draws:
        lo, span = (-1.0, 2.0) if mode == prng.UNIFORM else (0.0, 1.0)
        out.append(fn(key, int(np.prod(shape)), mode, span, lo, scale,
                      device=dev))
    return out


def phase_threefry(dev, card):
    """The threefry kernel against its plain version on the card, bit for
    bit, at the training paths' sizes (threefry_cases), and the full
    permutation through each; kernel, plain and torch.rand ms beside the
    bound at each size; one Elastic2D batch on the card against the same
    key on the CPU (fields equal bit for bit there too). Returns the
    kernel's numbers for the kernels line."""
    rows = []
    for name, draws, n_perm in threefry_cases():
        got = _draw_all(draws, dev, prng.threefry2x32)
        want = _draw_all(draws, dev, prng.threefry2x32_reference)
        n = sum(g.numel() for g in got)
        err = 0.0
        for g, w in zip(got, want):
            if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
                raise AssertionError(f"threefry kernel differs from its "
                                     f"plain version: {name}")
            if g.dtype == torch.float32:
                err = max(err, (g - w).abs().max().item())
        del got, want
        reps = 10 if n < 3e7 else 4
        ms = cuda_ms(lambda: _draw_all(draws, dev, prng.threefry2x32), reps)
        plain_ms = cuda_ms(lambda: _draw_all(
            draws, dev, prng.threefry2x32_reference), 2)
        rand_ms = cuda_ms(lambda: torch.rand(n, device=dev), reps)
        bound = sum(threefry_bound_ms(int(np.prod(shape)), mode)
                    for _, shape, mode, _ in draws)
        extra = ""
        if n_perm:
            key = prng.PRNGKey(1000)
            perm = prng.permutation(key, n_perm, device=dev)
            if not torch.equal(perm, prng.permutation_reference(key, n_perm,
                                                                dev)):
                raise AssertionError("permutation through the kernel "
                                     "differs from the plain version's")
            if not torch.equal(torch.sort(perm).values,
                               torch.arange(n_perm, device=dev)):
                raise AssertionError("permutation is not one")
            p_ms = cuda_ms(lambda: prng.permutation(key, n_perm, device=dev),
                           2)
            pp_ms = cuda_ms(lambda: prng.permutation_reference(
                key, n_perm, dev), 1)
            extra = (f"; the whole permutation (draws + stable sorts + "
                     f"gathers) {p_ms:.3f} ms, with the plain draws "
                     f"{pp_ms:.3f} ms, indices equal")
        log(f"[{card}] threefry2x32 {name}: {n} values in {len(draws)} "
            f"launches, bit-equal to the plain version; kernel {ms:.4f} ms, "
            f"plain {plain_ms:.3f} ms, bound {bound:.4f} ms (int32 "
            f"operations; the kernel at {100 * bound / ms:.1f}% of it), "
            f"torch.rand of as many {rand_ms:.4f} ms (for scale){extra}")
        rows.append(dict(name=name, n=n, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound, err=err))

    # One Elastic2D batch of train-256 on the card and on the CPU
    aug = Elastic2D(alpha=[0, 450], sigma=[20, 30], apply_prob=1.0, seed=7)
    key, alphas, sigmas, apply = aug.draw_batch_params(BATCH)
    rng = np.random.RandomState(7)
    images = rng.rand(BATCH, DIM, DIM, N_CHANNELS).astype(np.float32)
    labels = rng.randint(0, N_CLASSES, (BATCH, DIM, DIM)).astype(np.float32)
    bg = np.zeros((BATCH, N_CHANNELS), np.float32)
    out = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        out[name] = [t.cpu() for t in elastic.elastic_deform_2d_batch(
            key, torch.from_numpy(images).to(d),
            torch.from_numpy(labels).to(d), alphas, sigmas, apply, bg)]
    fields_equal = torch.equal(
        prng.uniform(key, (BATCH, DIM, DIM), -1.0, 1.0, device=dev).cpu(),
        prng.uniform(key, (BATCH, DIM, DIM), -1.0, 1.0, device="cpu"))
    img_err = (out["card"][0] - out["cpu"][0]).abs().max().item()
    share = (out["card"][1] == out["cpu"][1]).float().mean().item()
    log(f"[{card}] Elastic2D batch ({BATCH} x {DIM}^2, alpha up to 450, "
        f"sigma 20-30) from one key, card vs CPU: noise fields bit-equal "
        f"{fields_equal}; images max abs err {img_err:.3g} (<= "
        f"{ELASTIC_CARD_TOL}), labels equal on {share:.6f} of pixels (>= "
        f"{ELASTIC_CARD_SHARE})")
    if not (fields_equal and img_err <= ELASTIC_CARD_TOL
            and share >= ELASTIC_CARD_SHARE):
        raise AssertionError("Elastic2D on the card differs from the CPU")
    return dict(ms=sum(r["ms"] for r in rows),
                plain_ms=sum(r["plain_ms"] for r in rows),
                bound_ms=sum(r["bound_ms"] for r in rows),
                max_abs_err=max(r["err"] for r in rows))


def oracle_labels(size=64):
    lab = np.zeros((size, size, size), np.uint8)
    lab[8:28, 10:30, 12:34] = 1
    lab[34:54, 14:40, 20:44] = 2
    lab[14:30, 36:56, 38:58] = 3
    lab[40:50, 44:58, 6:18] = 1
    return lab


def phase_oracle(dev):
    """Feed a label volume as the image through a one-hot oracle 'model':
    each resampler must reconstruct it (interior accuracy > 0.95). 'auto'
    with a stage guard no plane stack fits must fall back to gather."""
    size, nc = 64, 4
    lab = oracle_labels(size)
    views = geometry.get_random_views(4, rng=np.random.RandomState(3))
    interior = np.zeros_like(lab, bool)
    interior[2:-2, 2:-2, 2:-2] = True
    for name, resampler, modes in (("shear", "shear", {"shear"}),
                                   ("gather", "gather", {"gather"}),
                                   ("auto, guard lowered", "auto",
                                    {"gather"})):
        img = Image(lab.astype(np.float32)[..., None], np.eye(4))
        pred = MultiViewPredictor(OneHotOracle(nc), sample_dim=size,
                                  real_space_span=float(size - 2),
                                  n_classes=nc, device=dev,
                                  resampler=resampler)
        if name.startswith("auto"):
            pred.stage_bytes_max = 1.0
        fused, per_view = pred.predict_image(img, views, n_planes="same+20",
                                             return_probs=True)
        if fused.shape != lab.shape + (nc,) or not np.isfinite(fused).all():
            raise AssertionError(f"oracle output shape {fused.shape}")
        if set(pred.remap_modes) != modes:
            raise AssertionError(f"oracle {name}: modes {pred.remap_modes}")
        sum_err = float(np.abs(fused.sum(-1) - 1.0).max())
        acc = float((fused.argmax(-1) == lab)[interior].mean())
        acc_v = [float((pv == lab)[interior].mean()) for pv in per_view]
        log(f"oracle 64^3, 4 views, {name} ({pred.remap_modes[0]}): fused "
            f"interior accuracy {acc:.4f} (> 0.95), per-view "
            f"{[round(a, 4) for a in acc_v]}, fused probability sum max "
            f"|err| {sum_err:.3g} (< 1e-2)")
        if acc <= 0.95 or sum_err >= 1e-2:
            raise AssertionError(f"oracle reconstruction failed ({name})")


def check_unet_against_host(model_bf16, state, dev):
    """The full-width UNet on the card in float32 (TF32 off) against the
    same weights on the host, on a small input: the card's convolutions
    compute the reference function."""
    ref = UNet(N_CLASSES, N_CHANNELS, DEPTH, CF).eval()
    ref.load_state_dict(state)
    card = UNet(N_CLASSES, N_CHANNELS, DEPTH, CF).to(dev).eval()
    card.load_state_dict(state)
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 1, 64, 64)
                         .astype(np.float32))
    with torch.inference_mode():
        want = ref(x)
        got = card(x.to(dev)).cpu()
        bf16 = model_bf16(x.to(dev)).cpu()
    e32 = (got - want).abs().max().item()
    e16 = (bf16 - want).abs().max().item()
    log(f"UNet cf=2 on a 2x64x64 input: card f32 vs host f32 max abs err "
        f"{e32:.3g} (< 1e-4); card bf16 vs host f32 {e16:.3g}")
    if not (e32 < 1e-4 and torch.isfinite(bf16).all()):
        raise AssertionError("UNet on the card disagrees with the host")


def setup_main_path(dev, tmp):
    """The full-width model from a JAX-format checkpoint, the predictor,
    the views, the fusion weights, the volumes and the first volume's
    shear plans (all volumes share the geometry)."""
    path = Path(tmp) / "unet_cf2.npz"
    jax_format_unet_weights(path, N_CLASSES, N_CHANNELS, DEPTH, CF, seed=0)
    params, stats, _ = checkpoint.load_weights(path)
    model = UNet(N_CLASSES, N_CHANNELS, DEPTH, CF, dtype=torch.bfloat16)
    state = checkpoint.unet_state_dict_from_jax(params, stats, model)
    model.load_state_dict(state)
    model = model.to(dev).eval()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"UNet cf={CF} depth={DEPTH} dim={DIM} classes={N_CLASSES}: "
        f"{n_params} parameters ({n_params / 1e6:.1f} M), bf16 compute")
    check_unet_against_host(model, state, dev)

    views = geometry.sample_random_views_with_angle_restriction(
        N_VIEWS, 60, rng=np.random.RandomState(42))
    rng = np.random.RandomState(1)
    fusion = {"fusion": {
        "W": (1.0 + 0.1 * rng.randn(N_VIEWS, N_CLASSES)).astype(np.float32),
        "b": (0.1 * rng.randn(1, N_CLASSES)).astype(np.float32)}}
    predictor = MultiViewPredictor(model, sample_dim=DIM,
                                   real_space_span=float(DIM - 1),
                                   n_classes=N_CLASSES, device=dev)
    images = [Image(rng.rand(DIM, DIM, DIM, N_CHANNELS).astype(np.float32),
                    np.eye(4)) for _ in range(N_VOLUMES)]

    # Plans of the first volume (all volumes share the geometry)
    plans = view_plans(predictor, images[0], views)
    offsets, n_valid = predictor._prepare_offsets(images[0], "same+20")
    log(f"plane stack {DIM}x{DIM}x{len(offsets)} ({n_valid} valid planes, "
        f"U-Net chunk {predictor._chunk_for(len(offsets))})")
    return predictor, images, views, fusion, plans


def phase_main_path(dev, predictor, images, views, fusion):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    shear_pass.launches = 0
    seconds, per_volume_launches, shares, maps = [], [], [], []
    for i, img in enumerate(images):
        before = shear_pass.launches
        t0 = time.perf_counter()
        fused, _ = predictor.predict_image(img, views, fusion_params=fusion,
                                           n_planes="same+20",
                                           return_per_view=False)
        seconds.append(time.perf_counter() - t0)  # ends in a host fetch
        per_volume_launches.append(shear_pass.launches - before)
        maps.append(fused)
        ms = predictor.stage_ms()
        shares.append(ms)
        if (fused.shape != (DIM,) * 3 or fused.dtype != np.uint8
                or fused.max() >= N_CLASSES):
            raise AssertionError(f"fused map {fused.shape} {fused.dtype}")
        counts = np.bincount(fused.ravel(), minlength=N_CLASSES)
        log(f"volume {i}: {seconds[-1]:.3f} s, shear-pass launches "
            f"{per_volume_launches[-1]}, stage ms "
            f"{ {k: round(v, 2) for k, v in ms.items()} }, class counts "
            f"{counts.tolist()}")
    launches = shear_pass.launches
    peak = torch.cuda.max_memory_allocated(dev)
    expected = 12 * N_VIEWS
    if any(n != expected for n in per_volume_launches):
        raise AssertionError(f"shear-pass launches per volume "
                             f"{per_volume_launches}, expected {expected}")
    steady = float(np.mean(seconds[1:]))
    unet = float(np.mean([s["unet"] for s in shares[1:]]))
    resample = float(np.mean([s["stack"] + s["remap"] for s in shares[1:]]))
    total = float(np.mean([sum(s.values()) for s in shares[1:]]))
    n_valid = len(geometry.plane_offsets(images[0], "same+20",
                                         predictor.span, predictor.dim))
    # The plain decoder's unpadded count, whatever form the predictor runs,
    # so that the rate stays comparable across forms
    model_flops = unet_main_flops() * N_VIEWS * n_valid
    tflops = model_flops / (unet * 1e-3) / 1e12
    log(f"main path: {steady:.3f} s/volume after the first "
        f"({60.0 / steady:.2f} volumes/min; first {seconds[0]:.3f} s; "
        f"U-Net form {unet_form(predictor.model)}); "
        f"U-Net {unet:.1f} ms ({100 * unet / total:.1f}%), resample "
        f"(stack + remap + accumulate) {resample:.1f} ms "
        f"({100 * resample / total:.1f}%) of {total:.1f} ms device-event "
        f"time; peak memory {peak / 2**30:.2f} GiB; shear-pass launches "
        f"{launches} = {N_VOLUMES} x {expected}")
    log(f"U-Net: {model_flops / 1e12:.2f} TFLOP per volume ({N_VIEWS} views "
        f"x {n_valid} planes, padded planes not counted) -> {tflops:.1f} "
        f"TFLOP/s over U-Net device time, {100 * tflops / 989:.1f}% of the "
        f"H100 SXM's 989 dense bf16 TFLOP/s")

    # The fused probabilities of one volume: finite, summing to one, and
    # their argmax is its class map above
    probs, _ = predictor.predict_image(images[0], views, fusion_params=fusion,
                                       return_per_view=False,
                                       return_probs=True)
    cls = maps[0]
    agree = float((probs.argmax(-1) == cls).mean())
    sum_err = float(np.abs(probs.sum(-1) - 1.0).max())
    log(f"fused probabilities: finite {bool(np.isfinite(probs).all())}, "
        f"sum max |err| {sum_err:.3g}, argmax vs class map agreement "
        f"{agree:.6f}")
    if not (np.isfinite(probs).all() and sum_err < 1e-4 and agree > 0.999):
        raise AssertionError("fused probabilities are wrong")
    runs = [(secs, ms["unet"]) for secs, ms in zip(seconds, shares)]
    return launches, (runs, maps)


# ------------------------------------------------------------- U-Net forms
# The U-Net's forms at the main path's width, each with the fields that
# select it; "dilated+pad8" is the JAX predictor's form
UNET_ARMS = (
    ("naive", {}),
    ("dilated", {"dilated_upconv": True}),
    ("pad8", {"lane_pad": 8}),
    ("dilated+pad8", {"dilated_upconv": True, "lane_pad": 8}),
    ("dilated+pad8+fused_bn", {"dilated_upconv": True, "lane_pad": 8,
                               "predict_fused_bn": True}),
    ("subpixel", {"subpixel_decoder": True}),
)
# Float32 (TF32 off) against the naive form: the forms reassociate sums
# (and pad with exact zeros), so they stay within the card-vs-host bound
# of check_unet_against_host; bf16 argmax against the naive bf16 form:
# random weights have near-ties that one bf16 rounding flips (0.9966 of
# voxels in a 32^3 CPU rehearsal of the per-view gate)
FORMS_F32_TOL, FORMS_AGREEMENT = 1e-4, 0.99
FORMS_WARMUP, FORMS_REPS = 2, 6
# The main path's build group, as `mp init_project` writes it
BUILD_MAIN = {"model_class_name": "UNet", "n_classes": N_CLASSES,
              "n_channels": N_CHANNELS, "dim": DIM, "depth": DEPTH,
              "complexity_factor": CF, "out_activation": "softmax"}


def unet_main_flops():
    """Forward FLOPs of one DIM x DIM plane through the main path's U-Net
    with the plain decoder and unpadded filters (the analytic count that
    phase_callbacks_tools holds against the hook count), whatever form
    runs."""
    return unet_forward_flops(DIM, N_CLASSES, N_CHANNELS, DEPTH,
                              complexity_factor=CF)


def unet_form(model):
    """The form fields of a U-Net, for the log."""
    return {k: getattr(model, k) for k in (
        "dilated_upconv", "subpixel_decoder", "predict_fused_bn",
        "lane_pad") if getattr(model, k, None)} or "naive"


def phase_unet_variants(dev, tmp, predictor, img, views, fusion, card,
                        main):
    """The U-Net's forms on predict-256's model (cf 2, depth 4, 7
    classes), on one U-Net chunk of the main path (`_chunk_for` of its
    plane stack) of random 256^2 planes:

    1. every form in float32 with TF32 off against the naive form (gate
       FORMS_F32_TOL), and a JAX-format checkpoint written with lane_pad 8
       loaded through build_model + load_unet_weights the same way;
    2. in bf16 (the predictor's dtype) each form's forward time by CUDA
       events, in rounds over the forms (median and quartiles of
       FORMS_REPS after FORMS_WARMUP), its peak memory, and its argmax
       against the naive form's (gate FORMS_AGREEMENT, finite);
    3. TFLOP/s of each form on the naive unpadded count;
    4. predict-256 of the main path's second volume `img` in the naive
       form (MP_PREDICT_DILATED=0, MP_PREDICT_LANE_PAD=0), twice, against
       the main path's runs in the predictor's default form (`main`:
       its (s, U-Net ms) per volume and class maps, from
       phase_main_path): s/volume, U-Net ms and the class maps'
       agreement on that volume (gate FORMS_AGREEMENT; 72 shear-pass
       launches each, gated).

    Returns the shear-pass launches of step 4."""
    t_phase = time.perf_counter()
    offsets, _ = predictor._prepare_offsets(img, "same+20")
    chunk = predictor._chunk_for(len(offsets))
    # setup_main_path's weights, through the entry points `mp predict`
    # uses
    naive = load_unet_weights(build_model(BUILD_MAIN),
                              Path(tmp) / "unet_cf2.npz").to(dev)
    arms = {name: naive.twin(**fields) for name, fields in UNET_ARMS}
    path = Path(tmp) / "unet_cf2_lane_pad8.npz"
    checkpoint.save_unet_weights(path, arms["pad8"])
    loaded = load_unet_weights(
        build_model({**BUILD_MAIN, "lane_pad": 8}), path).to(dev).eval()
    if loaded.lane_pad != 8:
        raise AssertionError("build_model dropped lane_pad")
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(chunk, N_CHANNELS, DIM, DIM, generator=gen, device=dev)

    if torch.backends.cudnn.allow_tf32:  # require_cuda turns it off
        raise AssertionError("TF32 convolutions are on")
    errs = {}
    with torch.inference_mode():
        ref = arms["naive"](x)
        for name, arm in [*arms.items(), ("pad8 checkpoint", loaded)]:
            if name != "naive":
                errs[name] = (arm(x) - ref).abs().max().item()
    del ref, loaded
    log(f"U-Net forms, float32 (TF32 off), {chunk} planes of {DIM}^2, max "
        f"abs err against the naive form: "
        f"{ {k: float(f'{v:.3g}') for k, v in errs.items()} } (< "
        f"{FORMS_F32_TOL:g})")
    if not all(e < FORMS_F32_TOL for e in errs.values()):
        raise AssertionError(f"a U-Net form disagrees in float32: {errs}")

    for arm in arms.values():
        arm.dtype = torch.bfloat16
    flops = unet_main_flops() * chunk
    agree, peaks, times = {}, {}, {name: [] for name in arms}
    with torch.inference_mode():
        want = arms["naive"](x).argmax(1)
        for name, arm in arms.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            out = arm(x)
            torch.cuda.synchronize()
            peaks[name] = torch.cuda.max_memory_allocated(dev)
            if not torch.isfinite(out).all():
                raise AssertionError(f"U-Net form {name}: non-finite bf16")
            agree[name] = (out.argmax(1) == want).float().mean().item()
            del out
            for _ in range(FORMS_WARMUP - 1):
                arm(x)
        events = []
        for _ in range(FORMS_REPS):  # rounds over the forms
            for name, arm in arms.items():
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                arm(x)
                end.record()
                events.append((name, start, end))
        torch.cuda.synchronize()
        for name, start, end in events:
            times[name].append(start.elapsed_time(end))
    del want, x
    stats = {name: tuple(float(np.percentile(t, q)) for q in (50, 25, 75))
             for name, t in times.items()}
    base = stats["naive"][0]
    log(f"[{card}] U-Net forms, bf16, one chunk of {chunk} planes of "
        f"{DIM}^2 (median and quartiles of {FORMS_REPS} after "
        f"{FORMS_WARMUP} warm-up, CUDA events, in rounds over the forms; "
        f"TFLOP/s on the naive unpadded count, {flops / 1e12:.3f} TFLOP):")
    for name, (med, q1, q3) in stats.items():
        log(f"  {name:22s} {med:8.3f} ms ({q1:.3f} / {q3:.3f}), "
            f"{flops / (med * 1e-3) / 1e12:6.1f} TFLOP/s, "
            f"{100 * (med / base - 1):+.1f}% vs naive; peak "
            f"{peaks[name] / 2**30:.2f} GiB; argmax vs naive bf16 "
            f"{agree[name]:.6f}")
    if min(agree.values()) < FORMS_AGREEMENT:
        raise AssertionError(f"bf16 forms' argmax agreement {agree}")
    del arms, naive

    # predict-256 with the predictor's default form against the naive one
    with mock.patch.dict(os.environ, {"MP_PREDICT_DILATED": "0",
                                      "MP_PREDICT_LANE_PAD": "0"}):
        plain = MultiViewPredictor(
            load_unet_weights(build_model(BUILD_MAIN, mixed_precision=True),
                              Path(tmp) / "unet_cf2.npz").to(dev).eval(),
            sample_dim=DIM, real_space_span=float(DIM - 1),
            n_classes=N_CLASSES, device=dev)
    if unet_form(plain.model) != "naive":
        raise AssertionError(f"MP_PREDICT_DILATED=0 / MP_PREDICT_LANE_PAD=0"
                             f" left the form {unet_form(plain.model)}")
    main_runs, main_maps = main
    runs = {"naive": [], "default": main_runs[1:]}
    maps = {"default": main_maps[1]}
    launches = 0
    for _ in range(2):
        shear_pass.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cls, _ = plain.predict_image(img, views, fusion_params=fusion,
                                     n_planes="same+20",
                                     return_per_view=False)
        secs = time.perf_counter() - t0
        if shear_pass.launches != 12 * N_VIEWS:
            raise AssertionError(f"naive predict: {shear_pass.launches} "
                                 f"shear-pass launches")
        launches += shear_pass.launches
        runs["naive"].append((secs, plain.stage_ms()["unet"]))
        maps["naive"] = cls
    same = float((maps["naive"] == maps["default"]).mean())
    log(f"[{card}] predict-{DIM}, naive form (this volume, twice) vs the "
        f"predictor's default {unet_form(predictor.model)} (the main path's "
        f"volumes after the first): s/volume naive "
        f"{[round(r[0], 3) for r in runs['naive']]}"
        f", default {[round(r[0], 3) for r in runs['default']]}; U-Net ms "
        f"naive {[round(r[1], 1) for r in runs['naive']]}, default "
        f"{[round(r[1], 1) for r in runs['default']]}; class maps equal "
        f"in {same:.6f} of voxels (>= {FORMS_AGREEMENT})")
    if same < FORMS_AGREEMENT:
        raise AssertionError("the default form's class map differs")
    del plain
    torch.cuda.empty_cache()
    log(f"U-Net forms phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


# The H100 SXM's HBM rate: the bound of a bandwidth-bound pass
HBM_BYTES_PER_S = 3.35e12
# Dense-W bmm arm vs the kernel: W's weights are rounded to bf16 (2^-9
# relative) and the sum is rounded to bf16 at another place; over six
# passes of unit-range data (Catmull-Rom sum |w| <= 1.25 carries earlier
# differences forward) the two stay within 2^-4
LIBRARY_TOL = 2.0 ** -4


def dense_pass(op, shape, method, dtype, dev):
    """The JAX package's impl="matmul" form of one main-path pass (q set)
    as one torch.bmm: (the permutation to (q, m, r, C), the dense (Q, T,
    S) W in `dtype`).
    W is built from pass_positions/tap_parts, in-range taps only, in
    float32 and cast once, as that executor casts it."""
    m, q = op.m, op.q
    r = 3 - m - q
    Q, S = shape[q], shape[m]
    pos = pass_positions(op, Q, dev)
    W = torch.zeros(Q, int(op.out_extent), S, device=dev)
    for idx, w in tap_parts(pos, method):
        ok = (idx >= 0) & (idx < S)
        W.scatter_add_(2, idx.clamp(0, S - 1)[..., None],
                       (w * ok)[..., None])
    return (q, m, r, 3), W.to(dtype)


def library_arm(plan, method, A0):
    """(ms of the 6-pass plan as permute -> contiguous (Q, S, R*C) ->
    torch.bmm -> permute back, ms of the bmm calls alone, the result)."""
    dev, dtype = A0.device, A0.dtype
    steps, A = [], A0
    for i, op in enumerate(plan.ops):
        shape = [e for (_, e) in plan.stages[i]]
        perm, W = dense_pass(op, shape, method, dtype, dev)
        steps.append((perm, W))
    inv = [tuple(int(i) for i in np.argsort(p)) for p, _ in steps]

    def run():
        A = A0
        for (perm, W), back in zip(steps, inv):
            Q, S, R, C = (A.shape[a] for a in perm)
            Ac = A.permute(*perm).reshape(Q, S, R * C)
            out = torch.bmm(W, Ac).view(Q, W.shape[1], R, C)
            A = out.permute(*back).contiguous()
        return A

    canon, A = [], A0
    for (perm, W), back in zip(steps, inv):
        Q, S, R, C = (A.shape[a] for a in perm)
        canon.append(A.permute(*perm).reshape(Q, S, R * C))
        A = torch.bmm(W, canon[-1]).view(Q, W.shape[1], R, C)
        A = A.permute(*back).contiguous()

    def bmm_only():
        for (_, W), Ac in zip(steps, canon):
            torch.bmm(W, Ac)

    result = run()
    run()
    ms = cuda_ms(run, 3)
    bmm_only()
    bmm_ms = cuda_ms(bmm_only, 3)
    del canon, steps
    return ms, bmm_ms, result


def phase_reference_swap(predictor, img, views, fusion):
    """One 256^3 main-path volume through predict_image with the kernel,
    then with shear_pass_reference put in the kernel's place (in
    ops.shear, for this comparison only): the uint8 class maps must be
    identical, since the kernel is bit-equal to its plain version. cuDNN
    is held to deterministic algorithms for both runs."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        with_kernel, _ = predictor.predict_image(
            img, views, fusion_params=fusion, return_per_view=False)
        t1 = time.perf_counter()
        shear_module.shear_pass = shear_pass_reference
        try:
            with_plain, _ = predictor.predict_image(
                img, views, fusion_params=fusion, return_per_view=False)
        finally:
            shear_module.shear_pass = shear_pass
        t2 = time.perf_counter()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    differ = int((with_kernel != with_plain).sum())
    log(f"main-path volume with the kernel ({t1 - t0:.3f} s) vs with "
        f"shear_pass_reference in its place ({t2 - t1:.3f} s): {differ} of "
        f"{with_kernel.size} class-map voxels differ (must be 0)")
    if differ:
        raise AssertionError("class map differs with the plain shear pass")


def phase_timing(dev, plans):
    """One view's stack plan and remap plan (6 passes each) at the main
    path's shapes, kernel vs plain, alternating plain/kernel/kernel/plain,
    with the bound (read each input stage once, write each output stage
    once, at 3.35 TB/s) and the library arm (dense-W bmm with its layout
    copies, and the bmm alone) held against the kernel within
    LIBRARY_TOL; and the remap plan at the shapes of a channel group of 2
    (C=3)."""
    (s_plan, _), (_, _, r_plan, _) = plans[0]
    out = {}
    for name, plan, method, ch in (("stack", s_plan, "cubic", N_CHANNELS + 1),
                                   ("remap", r_plan, "linear",
                                    N_CLASSES + 1),
                                   ("grouped remap", r_plan, "linear", 3)):
        shape = [ext for (_, ext) in plan.stages[0]]
        A0 = torch.rand(*shape, ch, device=dev).to(torch.bfloat16)

        def run(fn):
            A = A0
            for op in plan.ops:
                A = fn(A, op, method)
            return A

        times = {"plain": [], "kernel": []}
        for arm in ("plain", "kernel", "kernel", "plain"):
            fn = shear_pass if arm == "kernel" else shear_pass_reference
            run(fn)  # warm
            times[arm].append(cuda_ms(lambda: run(fn), 5))
        k, p = np.mean(times["kernel"]), np.mean(times["plain"])
        # Each pass alone: its time, share of its bound, (m, q) and EP
        per_pass, A = [], A0
        for op in plan.ops:
            ep = tile_plan(A.shape, op, method, A.dtype).ep
            B = shear_pass(A, op, method)
            t = cuda_ms(lambda: shear_pass(A, op, method), 5)
            share = (A.numel() + B.numel()) * 2 / HBM_BYTES_PER_S * 1e5 / t
            per_pass.append(f"(m={op.m}, q={op.q}, EP={ep}) {t:.3f} ms "
                            f"{share:.0f}%")
            A = B
        log(f"{name} plan, kernel per pass (time, share of its bound): "
            + "; ".join(per_pass))
        del A, B
        lib_ms, bmm_ms, lib_out = library_arm(plan, method, A0)
        lib_err = (lib_out.float() - run(shear_pass).float()).abs().max()
        lib_err = lib_err.item()
        del lib_out
        torch.cuda.empty_cache()
        nbytes = plan_bytes(plan, ch)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"{name} plan {tuple(plan.src_shape)} -> "
            f"{tuple(plan.out_shape)} x C={ch} bf16, 6 {method} passes: "
            f"kernel {k:.3f} ms, plain {p:.3f} ms (runs "
            f"{[round(t, 3) for t in times['kernel']]} / "
            f"{[round(t, 3) for t in times['plain']]}); bound "
            f"{bound:.3f} ms ({nbytes / 1e9:.3f} GB at 3.35 TB/s), kernel at "
            f"{100 * bound / k:.1f}% of it; library arm (dense-W torch.bmm "
            f"with layout copies) {lib_ms:.3f} ms, bmm alone {bmm_ms:.3f} "
            f"ms, vs kernel max abs err {lib_err:.3g} (tol "
            f"{LIBRARY_TOL:.3g})")
        if lib_err > LIBRARY_TOL:
            raise AssertionError(f"{name}: library arm vs kernel {lib_err}")
        out[name] = {"ms": k, "plain_ms": p, "bound_ms": bound,
                     "library_ms": lib_ms, "bmm_ms": bmm_ms}
    return out


def confident_stack(dev, d, P, nc, seed):
    """A (d, d, P, nc) bf16 probability stack with the confident,
    spatially coherent classes of a trained model: softmax of smoothed
    random logits. (The random-weight U-Net's output is near uniform,
    max probability about 1/7, so its argmax would flip at any bf16
    rounding and could not test a remap.)"""
    gen = torch.Generator(device=dev).manual_seed(seed)
    logits = torch.randn((nc, 1, d, d, P), generator=gen, device=dev)
    logits = torch.nn.functional.avg_pool3d(logits, 9, stride=1, padding=4)
    logits = logits / logits.std()
    probs = torch.softmax(8.0 * logits[:, 0].permute(1, 2, 3, 0), dim=-1)
    return probs.to(torch.bfloat16)


def phase_grouped_remap(dev, predictor, img, views, fusion, plans):
    """The channel-grouped remap at the main path's shapes: per view, a
    stage guard at that view's group-of-2 stage size makes the planner
    pick groups of 2, and the grouped remap of one prediction stack is
    held against the ungrouped remap of the same stack (probabilities
    within 2^-6, class maps >= 0.999), its plans' passes kernel vs plain
    at C=3. Then a whole volume through predict_image with the guard
    lowered to the largest group-of-2 stage, its shear-pass launches
    counted. Returns (the worst kernel vs plain error, the launches of one
    grouped volume)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    grouped = MultiViewPredictor(predictor.model, sample_dim=DIM,
                                 real_space_span=float(DIM - 1),
                                 n_classes=N_CLASSES, device=dev)
    vol_shape = img.interpolator.padded_shape()
    P_pad = len(predictor._prepare_offsets(img, "same+20")[0])
    worst = 0.0
    for v, (_, (_, _, r_plan, r_bounds)) in enumerate(plans):
        grouped.stage_bytes_max = plan_stage_bytes(r_plan, 2)
        mode = grouped._remap_group(r_plan, vol_shape, P_pad)
        if mode != ("grouped", 2):
            raise AssertionError(f"view {v}: guard at the group-of-2 stage "
                                 f"gave {mode}")
        pred = confident_stack(dev, DIM, P_pad, N_CLASSES, seed=v)
        ref = grouped.shear_remap(pred, r_plan, r_bounds, None)
        got = grouped.shear_remap(pred, r_plan, r_bounds, 2)
        torch.cuda.synchronize()
        err = (got.float() - ref).abs().max().item()
        agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
        t_ref = cuda_ms(lambda: grouped.shear_remap(pred, r_plan, r_bounds,
                                                    None), 2)
        t_grp = cuda_ms(lambda: grouped.shear_remap(pred, r_plan, r_bounds,
                                                    2), 2)
        e_k = compare_plan_passes(r_plan, "linear", 3, torch.bfloat16, gen)
        worst = max(worst, e_k)
        log(f"view {v}: grouped remap (groups of 2, bf16) vs ungrouped: "
            f"max abs err {err:.3g} (<= 2^-6), class agreement {agree:.6f} "
            f"(>= 0.999); {t_grp:.1f} ms vs {t_ref:.1f} ms; kernel vs plain "
            f"at C=3 max abs err {e_k:.3g}")
        if not (err <= 2.0 ** -6 and agree >= 0.999):
            raise AssertionError(f"grouped remap disagrees (view {v})")
        del pred, ref, got

    grouped.stage_bytes_max = max(plan_stage_bytes(r_plan, 2)
                                  for (_, (_, _, r_plan, _)) in plans)
    ref, _ = predictor.predict_image(img, views, fusion_params=fusion,
                                     return_per_view=False)
    secs, launches = [], []
    for _ in range(2):
        shear_pass.launches = 0
        t0 = time.perf_counter()
        cls, _ = grouped.predict_image(img, views, fusion_params=fusion,
                                       return_per_view=False)
        secs.append(time.perf_counter() - t0)
        launches.append(shear_pass.launches)
    expected = expected_launches(plans, grouped.remap_modes)
    if launches != [expected] * 2:
        raise AssertionError(f"grouped predict: shear-pass launches "
                             f"{launches}, expected {expected} per volume")
    if (not all(m.startswith("grouped") for m in grouped.remap_modes)
            or cls.shape != (DIM,) * 3 or cls.dtype != np.uint8
            or cls.max() >= N_CLASSES):
        raise AssertionError(f"grouped predict: {grouped.remap_modes}, "
                             f"{cls.shape} {cls.dtype}")
    ms = grouped.stage_ms()
    log(f"grouped predict_image {DIM}^3 (modes {grouped.remap_modes}, "
        f"shear-pass launches {launches[-1]} per volume): "
        f"{secs[-1]:.3f} s/volume (first {secs[0]:.3f} s), remap "
        f"{ms['remap']:.1f} ms per volume; class agreement with the "
        f"ungrouped map {float((cls == ref).mean()):.6f} (random weights: "
        f"near-uniform probabilities)")
    return worst, launches[-1]


def phase_gather(dev, predictor, img, views, fusion):
    """One full-width 256^3 volume through resampler='gather' (the exact
    corner-packed trilinear stack and nearest remap), timed next to the
    shear path. Gates: shape, dtype, class range."""
    gather = MultiViewPredictor(predictor.model, sample_dim=DIM,
                                real_space_span=float(DIM - 1),
                                n_classes=N_CLASSES, device=dev,
                                resampler="gather")
    shear_cls, _ = predictor.predict_image(img, views, fusion_params=fusion,
                                           return_per_view=False)
    shear_ms = predictor.stage_ms()
    secs = []
    shear_pass.launches = 0
    for _ in range(2):
        t0 = time.perf_counter()
        cls, _ = gather.predict_image(img, views, fusion_params=fusion,
                                      return_per_view=False)
        secs.append(time.perf_counter() - t0)
    if shear_pass.launches:
        raise AssertionError(f"the gather path launched the shear pass "
                             f"{shear_pass.launches} times")
    if (set(gather.remap_modes) != {"gather"} or cls.shape != (DIM,) * 3
            or cls.dtype != np.uint8 or cls.max() >= N_CLASSES):
        raise AssertionError(f"gather predict: {gather.remap_modes}, "
                             f"{cls.shape} {cls.dtype}")
    ms = gather.stage_ms()
    log(f"gather {DIM}^3: {secs[-1]:.3f} s/volume (first {secs[0]:.3f} s); "
        f"stage ms {({k: round(v, 1) for k, v in ms.items()})}; shear "
        f"path stage ms {({k: round(v, 1) for k, v in shear_ms.items()})}; "
        f"class agreement with shear {float((cls == shear_cls).mean()):.4f}; "
        f"shear-pass launches 0")
    img.interpolator.unload_device()
    return shear_pass.launches


# --------------------------------------------------------- per-view API
# The per-view inference API on the main path's model and first volume:
# get_view_from's stack and its two remaps, predict_single on both
# branches, and the kernel's whole resample against the float64 numpy
# reference
PV_SPEC = "same+20"
PV_MAPPED_SHARE, PV_GATHER_SHARE = 0.999, 0.9999
NP_SIZE, NP_CHANNELS = 64, 2
# Max abs error of a float32 6-pass resample against float64 on unit-range
# data: a few float32 ulps per pass, amplified up to 20x where the validity
# divisor is clamped at 0.05 near the border
NP_TOL = 1e-4
PS_SEED = 1234


def check_shear_np(dev):
    """The shear-pass kernel's whole resample (`shear_resample`, float32
    passes on the card) against `ops.shear.shear_resample_np` (float64
    numpy, independent of the kernel and of its plain torch version) on a
    64^3, 2-channel volume under an oblique affine: view 0's plane-stack
    plan (cubic) and view-remap plan (linear) as predict_image plans them.
    Gate: max abs error <= NP_TOL on each. Returns {plan: error}."""
    rng = np.random.RandomState(21)
    affine = np.eye(4)
    affine[:3, :3] = geometry.rotation_matrix([0.3, 0.2, 1.0],
                                              angle_deg=20) @ np.diag(
        [1.0, 1.1, 0.9])
    vol = rng.rand(NP_SIZE, NP_SIZE, NP_SIZE, NP_CHANNELS).astype(np.float32)
    img = Image(vol, affine)
    small = MultiViewPredictor(OneHotOracle(NP_CHANNELS), sample_dim=NP_SIZE,
                               real_space_span=float(NP_SIZE - 1),
                               n_classes=NP_CHANNELS, device=dev)
    view = geometry.sample_random_views_with_angle_restriction(
        1, 60, rng=np.random.RandomState(42))[0]
    (s_plan, s_bounds), (_, _, r_plan, r_bounds) = view_plans(
        small, img, [view])[0]
    pred = rng.rand(*r_plan.src_shape, NP_CHANNELS).astype(np.float32)
    fill = np.array([1.0, 0.0], np.float32)
    errs = {}
    for name, src, plan, bounds, method in (
            ("stack (cubic)", vol, s_plan, s_bounds, "cubic"),
            ("remap (linear)", pred, r_plan, r_bounds, "linear")):
        card = shear_resample(torch.from_numpy(src).to(dev), plan, fill,
                              method=method, compute_dtype=torch.float32,
                              exact_bounds=bounds).cpu().numpy()
        ref = shear_resample_np(src, plan, fill, method=method,
                                exact_bounds=bounds)
        if card.shape != ref.shape:
            raise AssertionError(f"{name}: {card.shape} vs {ref.shape}")
        errs[name] = float(np.abs(card - ref).max())
    log(f"shear-pass kernel's whole resample vs shear_resample_np (float64 "
        f"numpy) on a {NP_SIZE}^3, {NP_CHANNELS}-channel volume: max abs "
        f"error {errs} (bound {NP_TOL:g})")
    if max(errs.values()) > NP_TOL:
        raise AssertionError(f"shear_resample vs shear_resample_np {errs}")
    return errs


def write_image_nifti(vol, affine, path):
    """An uncompressed NIfTI of one volume, read back as a predict-mode
    ImagePair."""
    nifti.save(vol, path, affine=affine)
    return ImagePair(path, logger=ScreenLogger(False))


def phase_per_view(dev, predictor, img, views, tmp, card):
    """The per-view API at the main path's full width on its first 256^3
    volume:
    - get_view_from (view 0, same+20) on the volume rounded to bf16: X
      against the predictor's corner-packed bf16 stack within bf16
      rounding of the volume's range;
      X through the U-Net, then map_real_space_pred on get_view_from's
      grid and inverse basis, against predict_views_mapped of that view
      (argmax equal in >= PV_MAPPED_SHARE of voxels); map_view_pred_to_voxels
      at the voxels' real-space positions against map_real_space_pred
      (argmax equal in >= PV_GATHER_SHARE);
    - predict_single (iso_live, the 6 views) on the volume as a NIfTI
      ImagePair, bit-equal to predict_views_mapped;
    - the kernel's whole resample against shear_resample_np
      (check_shear_np, before the count).
    None of it launches the shear pass (gated). Returns those launches."""
    t_phase = time.perf_counter()
    check_shear_np(dev)
    shear_pass.launches = 0
    # The volume rounded to bf16: the float32 stack and the bf16-staged one
    # then read the same values, so the mapping gate measures the grid and
    # remap, not the staging's rounding amplified by random U-Net weights
    vol = torch.from_numpy(img.interpolator.image).to(torch.bfloat16).float()
    img = Image(vol.numpy(), img.affine)
    seq = multi_planar.IsotrophicLiveViewSequence2D(
        None, views=views, dim=DIM, batch_size=1, n_classes=N_CLASSES,
        real_space_span=predictor.span, device=dev, no_log=True,
        logger=ScreenLogger(False))
    view = views[0]
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        X, y, grid, inv_basis = seq.get_view_from(img, view, PV_SPEC)
        torch.cuda.synchronize()
        gv_s = time.perf_counter() - t0
        P = len(grid[2])
        if (y is not None or tuple(X.shape) != (DIM, DIM, P, N_CHANNELS)
                or X.dtype != torch.float32):
            raise AssertionError(f"get_view_from: X {tuple(X.shape)} "
                                 f"{X.dtype}, y {y is not None}")
        sampler = img.interpolator
        packed = sample_plane_stack_packed(
            sampler.device_volume_packed(dev), sampler.origin,
            sampler.spacing, sampler.rot_mat, geometry.plane_basis(view),
            grid[2], predictor.span, DIM, sampler.scaled_bg_value,
            valid_shape=sampler.valid_shape)
        x_err = float((X - packed).abs().max())
        x_tol = 2.0 ** -8 * float(np.abs(sampler.scaled_volume).max()) + 1e-6
        del packed
        pred = predictor._unet_stack(X)
        del X
        mapped = map_real_space_pred(pred, grid, inv_basis, img.affine,
                                     img.shape)
        cls = mapped.argmax(-1)
        del mapped
        ref = predictor.predict_views_mapped(img, [view])[0]
        ref_cls = torch.from_numpy(ref.argmax(-1)).to(dev)
        del ref
        mapped_share = float((cls == ref_cls).float().mean())
        del ref_cls
        pts = np.moveaxis(geometry.get_voxel_grid_real_space(
            img.shape[:3], img.affine), 0, -1).astype(np.float32)
        real_axis, offsets = grid[0], grid[2]
        gathered = map_view_pred_to_voxels(
            pred, [real_axis[0], real_axis[1] - real_axis[0]],
            [offsets[0], offsets[1] - offsets[0]], inv_basis, pts)
        gather_share = float((gathered.argmax(-1) == cls).float().mean())
        del gathered, pred, cls, pts
    sampler.unload_device()
    torch.cuda.empty_cache()
    log(f"[{card}] get_view_from (view 0, {PV_SPEC}, {P} planes): "
        f"{gv_s:.3f} s; X vs the predictor's bf16 packed stack max abs "
        f"{x_err:.3e} (bound {x_tol:.3e}); map_real_space_pred of its U-Net "
        f"stack vs predict_views_mapped: argmax equal in {mapped_share:.6f} "
        f"of voxels (gate {PV_MAPPED_SHARE}); map_view_pred_to_voxels vs "
        f"map_real_space_pred: {gather_share:.6f} (gate {PV_GATHER_SHARE})")
    if x_err > x_tol or mapped_share < PV_MAPPED_SHARE \
            or gather_share < PV_GATHER_SHARE:
        raise AssertionError("get_view_from gates failed (see above)")

    root = Path(tmp) / "per_view"
    root.mkdir()
    (root / "train_hparams.yaml").write_text(
        f"build:\n  dim: {DIM}\n  n_classes: {N_CLASSES}\nfit:\n"
        f"  intrp_style: iso_live\n  real_space_span: {predictor.span}\n"
        f"  bg_value: 0.0\n  scaler: null\n")
    hparams = YAMLHParams(root / "train_hparams.yaml", no_log=True,
                          no_version_control=True)
    image = write_image_nifti(sampler.image[..., 0], img.affine,
                              root / "img.nii")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = predict_single(image, predictor.model, hparams, views=views,
                         device=dev)
    ps_s = time.perf_counter() - t0
    with image.loaded_in_context():
        ref = predictor.predict_views_mapped(image, views)
    equal = bool(np.array_equal(out, ref))
    shape, dtype, nbytes = out.shape, out.dtype, out.nbytes
    del out, ref
    log(f"[{card}] predict_single (iso_live, {len(views)} views, {DIM}^3): "
        f"{ps_s:.3f} s; host array {shape} {dtype}, {nbytes / 1e9:.2f} GB; "
        f"bit-equal to predict_views_mapped: {equal}")
    if not equal or shape != (len(views),) + (DIM,) * 3 + (N_CLASSES,) \
            or dtype != np.float32:
        raise AssertionError("predict_single (iso_live) gates failed")
    if shear_pass.launches != 0:
        raise AssertionError(f"the per-view API launched "
                             f"{shear_pass.launches} shear passes")
    log(f"per-view phase: {time.perf_counter() - t_phase:.1f} s")
    return shear_pass.launches


def check_predict_single_3d(proj, hparams, dev, dirs, card):
    """predict_single (iso_live_3d) with the trained UNet3D on the 256^3
    val subject against pred_3D_iso driven directly over the same
    one-image sequence, numpy's stream seeded alike before each: the box
    sums within 1e-5 of their largest (the scatter's index_add_ atomics
    sum in no fixed order) and the class maps equal in >= 0.9999 of
    voxels."""
    model = build_model(hparams["build"], mixed_precision=bool(
        hparams["fit"].get("mixed_precision", False)),
        logger=ScreenLogger(False))
    model = load_unet_weights(model, get_best_model(proj / "model")).to(dev)
    image = ImagePair(dirs["val"] / "images" / "val_0.nii.gz",
                      logger=ScreenLogger(False))
    np.random.seed(PS_SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = predict_single(image, model, hparams, device=dev)
    secs = time.perf_counter() - t0
    seq = get_sequence(
        data_queue=fuse_and_predict._SingleImageQueue(image),
        is_validation=True, logger=None, dim=hparams["build"]["dim"],
        n_classes=hparams["build"]["n_classes"], no_log=True, device=dev,
        **hparams["fit"])
    np.random.seed(PS_SEED)
    with image.loaded_in_context():
        ref = pred_3D_iso(unet_predict_fn(model, dev), seq, image,
                          extra_boxes="3x", min_coverage=None)
    err = float(np.abs(out - ref).max())
    scale = float(np.abs(ref).max())
    share = float((out.argmax(-1) == ref.argmax(-1)).mean())
    log(f"[{card}] predict_single (iso_live_3d, trained UNet3D, {DIM}^3 val "
        f"subject, 3x extra boxes): {secs:.3f} s; vs pred_3D_iso driven "
        f"directly: max abs {err:.3e} of sums up to {scale:.3f}, class maps "
        f"equal in {share:.6f} of voxels")
    if out.shape != (DIM,) * 3 + (N_CLASSES,) or err > 1e-5 * scale \
            or share < 0.9999:
        raise AssertionError("predict_single (iso_live_3d) gates failed")


def phase_u8(dev):
    """uint8 staging: the dequantised volume on the card within
    range/510 of the scaled volume; the host -> device staging time of a
    256^3 volume in bf16 and in u8; the oracle's class map with u8 staging
    against bf16 staging (>= 0.99)."""
    rng = np.random.RandomState(7)
    vol = (rng.randn(DIM, DIM, DIM, N_CHANNELS) * 40 + 100).astype(np.float32)
    sampler = VolumeSampler(vol, np.eye(4))
    deq = sampler.device_volume_unpacked(dev, dtype=torch.float32,
                                         quantize=True)
    err = (deq[:DIM, :DIM, :DIM] - torch.from_numpy(vol).to(dev)).abs()
    err = float(err.max())
    # step/2 = range/510, plus the float32 rounding of codes*step + vmin
    bound = float((vol.max() - vol.min()) / 510)
    bound += 2 * float(np.spacing(np.abs(vol).max()))
    log(f"u8 dequantisation {DIM}^3 on the card: max abs err {err:.4g} "
        f"(<= range/510 + 2 ulp = {bound:.4g})")
    if err > bound:
        raise AssertionError("u8 dequantisation error over range/510")
    for quantize in (False, True):
        sampler.unload_device()
        sampler.prepare_host(quantize=quantize)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sampler.device_volume_unpacked(dev, quantize=quantize)
        torch.cuda.synchronize()
        form = "u8 codes" if quantize else "float32 -> bf16"
        log(f"staging {DIM}^3 ({form}): "
            f"{1e3 * (time.perf_counter() - t0):.1f} ms host -> device")
    sampler.unload_device()

    size, nc = 64, 4
    lab = oracle_labels(size)
    views = geometry.get_random_views(4, rng=np.random.RandomState(3))
    maps = {}
    for stage in ("bf16", "u8"):
        img = Image(lab.astype(np.float32)[..., None], np.eye(4))
        pred = MultiViewPredictor(OneHotOracle(nc), sample_dim=size,
                                  real_space_span=float(size - 2),
                                  n_classes=nc, device=dev,
                                  stage_dtype=stage)
        maps[stage], _ = pred.predict_image(img, views, n_planes="same+20",
                                            return_per_view=False)
    agree = float((maps["u8"] == maps["bf16"]).mean())
    log(f"oracle 64^3 class map, u8 vs bf16 staging: agreement {agree:.5f} "
        f"(>= 0.99)")
    if agree < 0.99:
        raise AssertionError("u8 staging changes the oracle's class map")


def structured_subject(dev, seed, size=DIM, n_classes=N_CLASSES):
    """A (size,)*3 float32 image and uint8 labels shaped like a scan, made
    on the card: zero background around an ellipsoid that holds a smoothed
    random field (intensity 100 + 40 * field, at least 1), and labels
    1..n_classes-1 as equal-volume bands of that field inside it (0
    outside)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    field = torch.randn((1, 1, size, size, size), generator=gen, device=dev)
    for _ in range(3):
        field = torch.nn.functional.avg_pool3d(field, 9, stride=1, padding=4)
    field = field[0, 0]
    field = (field - field.mean()) / field.std()
    ax = ((torch.arange(size, device=dev, dtype=torch.float32)
           - (size - 1) / 2) / (0.42 * size))
    fg = (ax[:, None, None] ** 2 + (ax[None, :, None] / 0.9) ** 2
          + (ax[None, None, :] / 0.8) ** 2) <= 1.0
    q = torch.arange(1, n_classes - 1, device=dev) / (n_classes - 1.0)
    bounds = torch.quantile(field[fg], q)
    vol = torch.where(fg, (100.0 + 40.0 * field).clamp_min(1.0), 0.0)
    lab = torch.where(fg, 1 + torch.bucketize(field, bounds), 0)
    return vol.cpu().numpy(), lab.to(torch.uint8).cpu().numpy()


def write_project(root, views, fusion, dev,
                  subjects=("subject_1", "subject_2"), edits=(), size=DIM):
    """A two-image (or `subjects`) `mp predict` project in the JAX
    package's layout: train_hparams.yaml (PROJECT_YAML with each (old,
    new) of `edits` replaced), views.npz, a JAX-format checkpoint of the
    main path's weights, fusion weights, and structured images (size^3,
    1 mm) with labels."""
    data = root / "data" / "test"
    for sub in ("images", "labels"):
        (data / sub).mkdir(parents=True)
    for seed, name in enumerate(subjects):
        vol, lab = structured_subject(dev, seed, size)
        nifti.save(vol, data / "images" / f"{name}.nii.gz", np.eye(4))
        nifti.save(lab, data / "labels" / f"{name}.nii.gz", np.eye(4))
    proj = root / "project"
    (proj / "model" / "fusion_weights").mkdir(parents=True)
    text = PROJECT_YAML
    for key, value in (("@DATA@", data), ("@N_CLASSES@", N_CLASSES),
                       ("@N_CHANNELS@", N_CHANNELS), ("@DIM@", DIM),
                       ("@CF@", CF), ("@DEPTH@", DEPTH),
                       ("@N_VIEWS@", N_VIEWS), ("@SPAN@", DIM - 1)):
        text = text.replace(key, str(value))
    for old, new in edits:
        if old not in text:
            raise AssertionError(f"project YAML lacks {old!r}")
        text = text.replace(old, new)
    (proj / "train_hparams.yaml").write_text(text)
    np.savez(proj / "views.npz", views)
    jax_format_unet_weights(proj / "model" / "@epoch_01_val_dice_0.10000.npz",
                            N_CLASSES, N_CHANNELS, DEPTH, CF, seed=0)
    np.savez(proj / "model" / "fusion_weights" / "unet_fusion_weights.npz",
             **{"params/fusion/W": fusion["fusion"]["W"],
                "params/fusion/b": fusion["fusion"]["b"]})
    return proj, data


def run_mp_predict_counted(proj, out, extra, plans, require_shear=True,
                           images=None):
    """One `mp predict` through its entry point, with the shear-pass count
    set to 0 just before it; each predict_image it makes is wrapped to
    read its own launches and remap modes (and to append its image to the
    list `images`, when given). Gates: one call per image, each
    with the launches its views' plans and remap modes give
    (`expected_launches`), and, with require_shear, every view on the
    ungrouped shear remap. Returns (per-image timings, the launches of the
    run)."""
    calls = []
    original = MultiViewPredictor.predict_image

    def counted(self, image, *args, **kwargs):
        if images is not None:
            images.append(image)
        before = shear_pass.launches
        result = original(self, image, *args, **kwargs)
        calls.append((image.identifier, shear_pass.launches - before,
                      list(self.remap_modes)))
        return result

    MultiViewPredictor.predict_image = counted
    try:
        shear_pass.launches = 0
        timings = port_mp.entry_func(["predict", "--project_dir", str(proj),
                                      "--out_dir", out, "--device", "cuda",
                                      *extra])
        launches = shear_pass.launches
    finally:
        MultiViewPredictor.predict_image = original
    for image_id, n, modes in calls:
        expected = expected_launches(plans, modes)
        if (n != expected or not n
                or (require_shear and modes != ["shear"] * N_VIEWS)):
            raise AssertionError(f"mp predict {out} {image_id}: {n} "
                                 f"shear-pass launches (expected {expected}),"
                                 f" remap modes {modes}")
    if len(calls) != len(timings) or launches != sum(n for _, n, _ in calls):
        raise AssertionError(f"mp predict {out}: {launches} shear-pass "
                             f"launches over {len(calls)} predict_image "
                             f"calls for {len(timings)} images")
    return timings, launches


def phase_mp_predict(dev, predictor, views, fusion, plans, tmp):
    """`mp predict` through its entry point on a two-image 256^3 NIfTI
    project: once with evaluation, once with --no_eval --continue into a
    fresh folder. Gates: each image's shear-pass launches and remap modes;
    a PRED.nii.gz per image, uint8 of the image's shape with values <
    n_classes; the result CSVs; and the per-view eval counts equal to
    counts taken from the fetched per-view maps. Then the host load of one
    image taken apart. Returns (the launches of both runs, the
    project)."""
    t0 = time.perf_counter()
    proj, data = write_project(Path(tmp), views, fusion, dev)
    log(f"mp predict project written in {time.perf_counter() - t0:.1f} s")
    expected = expected_launches(plans, ["shear"] * N_VIEWS)
    total = 0
    for out, extra in (("pred_eval", []),
                       ("pred_no_eval", ["--no_eval", "--continue"])):
        t0 = time.perf_counter()
        timings, launches = run_mp_predict_counted(proj, out, extra, plans)
        wall = time.perf_counter() - t0
        total += launches
        for image_id, t in sorted(timings.items()):
            pred = nifti.load(proj / out / "nii_files" / image_id /
                              "PRED.nii.gz").get_raw_data()
            if (pred.dtype != np.uint8 or pred.shape != (DIM,) * 3
                    or pred.max() >= N_CLASSES):
                raise AssertionError(f"{out}/{image_id}: PRED {pred.dtype} "
                                     f"{pred.shape}")
            log(f"mp predict {out} {image_id}: host load (decode + scale) "
                f"{t['load']:.3f} s, predict_image {t['predict']:.3f} s, "
                f"save {t['save']:.3f} s")
        log(f"mp predict {out}: {len(timings)} images in {wall:.1f} s wall; "
            f"shear-pass launches {launches} ({expected} per image)")
    results, pc = load_result_dicts(proj / "pred_eval" / "csv", views)
    if not np.isfinite(results.values).all():
        raise AssertionError("mp predict result table has missing entries")

    # The host load of subject_1 taken apart, in ImagePair.load's order,
    # then the scaling and the u8 codes of the predictor's prestage
    pair = ImagePair(data / "images" / "subject_1.nii.gz",
                     data / "labels" / "subject_1.nii.gz")
    pair.set_bg_value("1pct")
    pair.set_scaler("RobustScaler")
    split = {}
    for name, attr in (("decode image", "image"), ("decode labels", "labels"),
                       ("1pct bg value", "bg_value"),
                       ("RobustScaler fit", "scaler")):
        t0 = time.perf_counter()
        getattr(pair, attr)
        split[name] = time.perf_counter() - t0
    sampler = pair.interpolator
    for name, quantize in (("scale", False), ("u8 codes", True)):
        t0 = time.perf_counter()
        sampler.prepare_host(quantize=quantize)
        split[name] = time.perf_counter() - t0
    log("mp predict host load of subject_1 taken apart: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in split.items())
        + f" (bg value {pair.bg_value})")

    # Per-view counts on the card against the fetched per-view maps
    labels = pair.labels
    _, counts = predictor.predict_image(pair, views, fusion_params=fusion,
                                        eval_labels=labels)
    _, maps = predictor.predict_image(pair, views, fusion_params=fusion)
    lab_t = torch.from_numpy(labels)
    for v, (c, m) in enumerate(zip(counts, maps)):
        want = class_map_counts(torch.from_numpy(m), lab_t, N_CLASSES).numpy()
        if not np.array_equal(c, want):
            raise AssertionError(f"view {v}: device counts {c} != map "
                                 f"counts {want}")
        csv_dice = results.get("subject_1", str(views[v]))
        dice = float(np.nanmean(dice_from_counts(c)))
        if abs(csv_dice - dice) > 1e-3:
            raise AssertionError(f"view {v}: csv dice {csv_dice} vs {dice}")
    pair.unload()
    log(f"per-view eval counts on the card equal the counts of the fetched "
        f"per-view maps ({len(counts)} views) and the csv's per-view dice")
    return total, proj


def phase_large(dev, model, views, fusion):
    """512^3 at full width. First the kernel against its plain version on
    every pass of the stack and remap plans of the view with the largest
    remap stage, at the shapes this volume gives them: that stage holds
    more than 2^31 elements, so this checks the kernel's 64-bit indexing.
    Then one random 512^3 volume: the remap mode each view's planner chose
    (all ungrouped shear on an 80 GB card), its shear-pass launches,
    s/volume, peak device memory. Returns (the worst kernel vs plain
    error, the launches of the volume)."""
    rng = np.random.RandomState(13)
    img = Image(rng.rand(DIM_LARGE, DIM_LARGE, DIM_LARGE, N_CHANNELS)
                .astype(np.float32), np.eye(4))
    pred = MultiViewPredictor(model, sample_dim=DIM_LARGE,
                              real_space_span=float(DIM_LARGE - 1),
                              n_classes=N_CLASSES, device=dev)
    plans = view_plans(pred, img, views)
    # Elements of each view's largest remap stage, validity channel
    # included (plan_stage_bytes counts bf16 bytes)
    elems = [plan_stage_bytes(r_plan, N_CLASSES) / 2
             for (_, (_, _, r_plan, _)) in plans]
    v = int(np.argmax(elems))
    if elems[v] <= INDEX_32_LIMIT:
        raise AssertionError(f"largest {DIM_LARGE}^3 remap stage holds "
                             f"{elems[v]:.4g} elements, not past 2^31")
    (s_plan, _), (_, _, r_plan, _) = plans[v]
    gen = torch.Generator(device=dev).manual_seed(2)
    t0 = time.perf_counter()
    e_s = compare_plan_passes(s_plan, "cubic", N_CHANNELS + 1,
                              torch.bfloat16, gen)
    e_r = compare_plan_passes(r_plan, "linear", N_CLASSES + 1,
                              torch.bfloat16, gen)
    log(f"{DIM_LARGE}^3 view {v} (largest remap stage: {elems[v]:.4g} "
        f"elements > 2^31): kernel vs plain on every pass, stack (cubic, "
        f"C=2) max abs err {e_s:.3g}, remap (linear, C=8) {e_r:.3g} (bf16, "
        f"tol {TOL[torch.bfloat16]:.3g}); {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    shear_pass.launches = 0
    t0 = time.perf_counter()
    cls, _ = pred.predict_image(img, views, fusion_params=fusion,
                                return_per_view=False)
    secs = time.perf_counter() - t0
    launches = shear_pass.launches
    peak = torch.cuda.max_memory_allocated(dev)
    if (cls.shape != (DIM_LARGE,) * 3 or cls.dtype != np.uint8
            or cls.max() >= N_CLASSES):
        raise AssertionError(f"{DIM_LARGE}^3 map {cls.shape} {cls.dtype}")
    expected = expected_launches(plans, ["shear"] * N_VIEWS)
    if pred.remap_modes != ["shear"] * N_VIEWS or launches != expected:
        raise AssertionError(f"{DIM_LARGE}^3: remap modes {pred.remap_modes}"
                             f", shear-pass launches {launches} (expected "
                             f"{expected}, all ungrouped shear)")
    ms = pred.stage_ms()
    log(f"{DIM_LARGE}^3, {N_VIEWS} views (first and only volume): remap "
        f"modes {pred.remap_modes}; shear-pass launches {launches}; "
        f"{secs:.3f} s/volume; peak memory "
        f"{peak / 2**30:.2f} GiB (guards: stage "
        f"{pred.stage_bytes_max / 1e9:.1f} GB, remap peak "
        f"{pred.remap_peak_bytes_max / 1e9:.1f} GB); stage ms "
        f"{({k: round(v, 1) for k, v in ms.items()})}")
    return max(e_s, e_r), launches


# ------------------------------------------------------------------ training
# `mp train` of the bench model on a 3 + 1 subject 256^3 project: 2 epochs
# of 20 steps of 16 and 4 validation steps
TRAIN_EPOCHS, TRAIN_IMAGES, VAL_IMAGES, BATCH = 2, 320, 64, 16
N_TRAIN_SUBJECTS, N_VAL_SUBJECTS = 3, 1
BATCH_LARGE = 64
# The 3D preset's model at full width: UNet3D, complexity_factor 1, depth
# 3, 64 filters; the Auditor's dim_3d (64) for the box
DEPTH_3D, CF_3D, DIM_3D = 3, 1.0, 64
# Step checks: the float32 card/host comparison runs at batch 2 (a host
# step at full width and batch 16 would take minutes); Adam's first step
# moves a parameter by -lr * g / (|g| + eps), so a gradient near 0 may land
# anywhere in [-lr, lr] on either side: PARAM_TOL is a fraction of lr and
# PARAM_SHARE the share of parameters that must be within it
F32_BATCH, PARAM_TOL, PARAM_SHARE = 2, 1e-2, 0.99
# The overfit check: OVERFIT_STEPS bf16 Adam steps at lr 1e-3 on one batch
# must bring the loss below OVERFIT_RATIO of its first value (on the card
# the loss was at 0.07 of its first value after 20 steps and at 0.034
# after 50; a CPU rehearsal at depth 2, dim 32, batch 4 needs the ratio
# raised)
OVERFIT_STEPS, OVERFIT_RATIO = 20, 0.5


def write_train_project(root, dev):
    """3 train and 1 val structured 256^3 subjects, and a project made by
    the port's `mp init_project --data_dir` from its MultiPlanar preset
    (gate: the YAML holds the data folders passed in), then n_classes and
    dim given (real_space_span and n_channels left for the Auditor), the
    bench model's depth, width and batch, and the val subject as the test
    set."""
    data = root / "data"
    dirs = {"train": data / "train", "val": data / "val"}
    seed = 100
    for split, n in (("train", N_TRAIN_SUBJECTS), ("val", N_VAL_SUBJECTS)):
        for sub in ("images", "labels"):
            (dirs[split] / sub).mkdir(parents=True)
        for i in range(n):
            vol, lab = structured_subject(dev, seed)
            seed += 1
            nifti.save(vol, dirs[split] / "images" / f"{split}_{i}.nii.gz",
                       np.eye(4))
            nifti.save(lab, dirs[split] / "labels" / f"{split}_{i}.nii.gz",
                       np.eye(4))
    port_mp.entry_func(["init_project", "--name", "train_project", "--root",
                        str(root), "--data_dir", str(data)])
    proj = root / "train_project"
    hparams = YAMLHParams(proj / "train_hparams.yaml", no_log=True)
    for split in ("train", "val", "test"):
        got = hparams[f"{split}_data"]["base_dir"]
        if got != f"{data}/{split}":
            raise AssertionError(f"mp init_project wrote {split}_data "
                                 f"base_dir {got!r}, not {data}/{split}")
    text = hparams.string_rep
    for old, new in (
            (f"base_dir: {data}/test", f"base_dir: {dirs['val']}"),
            ("n_classes: Null", f"n_classes: {N_CLASSES}"),
            ("dim: Null", f"dim: {DIM}"),
            ("depth: 4", f"depth: {DEPTH}"),
            ("complexity_factor: 2", f"complexity_factor: {CF}"),
            ("batch_size: 16", f"batch_size: {BATCH}")):
        if old not in text:
            raise AssertionError(f"the init_project YAML lacks {old!r}")
        text = text.replace(old, new)
    (proj / "train_hparams.yaml").write_text(text)
    log(f"mp init_project wrote {proj / 'train_hparams.yaml'} with the data "
        f"folders passed in ({data}/{{train,val,test}})")
    return proj, dirs


# Threefry launches that `mp train` and `mp train_fusion` subprocesses
# logged, by path
LOGGED_DRAWS = {}


def logged_draws(text):
    """The threefry launches a script's log reports on its last such line
    (a run appends to the log of an earlier one)."""
    found = [int(line.rsplit(":", 1)[1]) for line in text.splitlines()
             if "threefry2x32 launches: " in line]
    if not found:
        raise AssertionError("the script's log reports no threefry launches")
    return found[-1]


def run_mp_train(proj, dev, n_epochs=TRAIN_EPOCHS, images=TRAIN_IMAGES,
                 val_images=VAL_IMAGES, sampler="Sampler: pooled path",
                 no_images=True):
    """`python -m multiplanarunet_tpu_torch.bin.mp train` in a subprocess;
    returns (wall seconds, the per-epoch (train loop s, callbacks s) its
    log reports). Fails on a non-zero exit, or when its log does not name
    the pooled sampler (`sampler` begins its log line)."""
    wall, _ = run_mp_script(
        ["train", "--project_dir", str(proj), "--device", str(dev),
         "--overwrite", *(["--no_images"] if no_images else []),
         "--epochs", str(n_epochs),
         "--train_images_per_epoch", str(images),
         "--val_images_per_epoch", str(val_images)], timeout=900)
    epochs = []
    text = (proj / "logs" / "train.txt").read_text()
    for line in text.splitlines():
        if " wall: train loop " in line:
            words = line.split()
            epochs.append((float(words[words.index("loop") + 1]),
                           float(words[words.index("validation") + 1])))
    if len(epochs) != n_epochs:
        raise AssertionError(f"mp train logged {len(epochs)} epoch timings")
    if sampler not in text:
        raise AssertionError(f"mp train's log lacks {sampler!r}: it did not "
                             f"sample on the pooled path")
    LOGGED_DRAWS[f"mp train {proj.parent.name}/{proj.name}"] = logged_draws(
        text)
    return wall, epochs


def run_mp_script(args, timeout, env=None):
    """`python -m multiplanarunet_tpu_torch.bin.mp <args>` in a
    subprocess from the repository root (with `env` added to the
    environment); returns (wall seconds, stdout). Fails on a non-zero
    exit."""
    cmd = [sys.executable, "-m", "multiplanarunet_tpu_torch.bin.mp", *args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=Path(__file__).resolve().parent,
                          capture_output=True, text=True, timeout=timeout,
                          env=None if env is None else {**os.environ, **env})
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        log(proc.stdout[-4000:])
        log(proc.stderr[-4000:])
        raise AssertionError(f"mp {args[0]} exited {proc.returncode}")
    return wall, proc.stdout


def check_trained_project(proj, tmp, n_epochs=TRAIN_EPOCHS, three_d=False):
    """Gates on what `mp train` wrote: n_epochs CSV rows with finite loss,
    val_loss, val_dice and lr; model_weights.npz and a best @epoch_*.npz
    holding exactly the keys and shapes of the JAX-format weights of the
    same build; for the 2D model views.npz with 6 unit vectors. Returns
    the CSV rows."""
    lines = (proj / "logs" / "training.csv").read_text().splitlines()
    head = lines[0].split(",")
    rows = [dict(zip(head, r.split(","))) for r in lines[1:]]
    if len(rows) != n_epochs:
        raise AssertionError(f"training.csv has {len(rows)} rows")
    for row in rows:
        for key in ("loss", "val_loss", "val_dice", "lr"):
            if not np.isfinite(float(row[key])):
                raise AssertionError(f"training.csv {key} = {row[key]}")
    ref_path = Path(tmp) / f"reference_train_build_{3 if three_d else 2}d.npz"
    if three_d:
        jax_format_unet_weights(ref_path, N_CLASSES, N_CHANNELS, DEPTH_3D,
                                CF_3D, seed=0, ndim=3)
    else:
        jax_format_unet_weights(ref_path, N_CLASSES, N_CHANNELS, DEPTH, CF,
                                seed=0)
    with np.load(ref_path) as ref:
        want = {k: ref[k].shape for k in ref.files}
    best = sorted((proj / "model").glob("@epoch_*.npz"))
    files = [proj / "model" / "model_weights.npz"] + best[-1:]
    if len(files) != 2 or not files[0].exists():
        raise AssertionError(f"model files {sorted((proj / 'model').iterdir())}")
    for f in files:
        with np.load(f) as data:
            got = {k: data[k].shape for k in data.files if k != "__meta__"}
        if got != want:
            raise AssertionError(f"{f.name}: keys/shapes differ from the "
                                 f"JAX-format weights of the build")
    if three_d:
        log(f"mp train (3D) wrote: training.csv rows "
            f"{[r['epoch'] for r in rows]} (loss {[r['loss'] for r in rows]}"
            f", val_dice {[r['val_dice'] for r in rows]}); "
            f"{[f.name for f in files]} with the {len(want)} keys and shapes "
            f"of the JAX-format UNet3D build")
        return rows
    views = np.load(proj / "views.npz")["arr_0"]
    if views.shape != (N_VIEWS, 3) or not np.allclose(
            np.linalg.norm(views, axis=1), 1.0, atol=1e-6):
        raise AssertionError(f"views.npz {views.shape}")
    log(f"mp train wrote: training.csv rows {[r['epoch'] for r in rows]} "
        f"(loss {[r['loss'] for r in rows]}, val_dice "
        f"{[r['val_dice'] for r in rows]}, lr {[r['lr'] for r in rows]}); "
        f"{[f.name for f in files]} with the {len(want)} keys and shapes of "
        f"the JAX-format build; views.npz {views.shape}, unit vectors")
    return rows


def step_time_ms(step, batches, warmup, timed):
    """(median, first quartile, third quartile) of CUDA-event times around
    step(*batch) alone, after `warmup` steps, cycling through batches."""
    times = []
    for i in range(warmup + timed):
        batch = batches[i % len(batches)]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(*batch)
        end.record()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append(start.elapsed_time(end))
    return tuple(float(np.percentile(times, q)) for q in (50, 25, 75))


def step_split_ms(step, batches, warmup, timed):
    """Mean CUDA-event ms of the train step's parts, as TrainStep runs
    them: forward + loss, backward, optimizer update (in-step metrics not
    included)."""
    names = ("forward + loss", "backward", "update")
    sums = dict.fromkeys(names, 0.0)
    for i in range(warmup + timed):
        X, y, w = batches[i % len(batches)]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        step.model.train()
        ev[0].record()
        out = step.model(X.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        loss = step.loss_obj(y, out, sample_weight=torch.as_tensor(
            w, device=X.device))
        ev[1].record()
        step.optimizer.zero_grad()
        loss.backward()
        ev[2].record()
        step.optimizer.step()
        ev[3].record()
        torch.cuda.synchronize()
        if i >= warmup:
            for name, a, b in zip(names, ev, ev[1:]):
                sums[name] += a.elapsed_time(b) / timed
    return sums


def profile_steps(step, batches, n=3):
    """torch.profiler over n steps: (device-busy ms per step, the top rows
    of its kernel table by self device time)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(n):
            step(*batches[i % len(batches)])
        torch.cuda.synchronize()
    events = prof.key_averages()
    # kernel rows only (the ops that launch them carry the same time)
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / n
    return busy, events.table(sort_by="self_device_time_total", row_limit=12)


@functools.cache
def glorot_model(dtype, seed=0, three_d=False, multitask=False):
    """The full-width UNet (the 3D preset's UNet3D with three_d, the
    MultiTask preset's two-task model with multitask) on the host with
    the JAX package's initial weights from PRNGKey(seed), drawn on the
    card (glorot_init), built once: every caller takes a copy."""
    if multitask:
        model = MultiTaskUNet2D(MT_TASKS, MT_CLASSES, [N_CHANNELS] * 2,
                                MT_DIMS, DEPTH, CF, dtype=dtype)
    elif three_d:
        model = UNet3D(N_CLASSES, N_CHANNELS, DEPTH_3D, CF_3D, dtype=dtype)
    else:
        model = UNet(N_CLASSES, N_CHANNELS, DEPTH, CF, dtype=dtype)
    return glorot_init(model, seed)


def fresh_step(dtype, dev, lr, seed=0, three_d=False, multitask=False):
    """A copy of glorot_model(dtype, seed, three_d, multitask) in train
    mode on `dev` with its Adam train step (the default loss and
    metric)."""
    model = copy.deepcopy(glorot_model(dtype, seed, three_d, multitask))
    model = model.to(dev).train()
    opt = init_optimizer("Adam", model.parameters(), lr=lr, epsilon=1e-8)
    step = (MultiTaskTrainStep if multitask else TrainStep)(
        model, opt, SparseCategoricalCrossentropy(),
        {"sparse_categorical_accuracy":
         METRICS["sparse_categorical_accuracy"]})
    return model, opt, step


def _batch_part(part, fn):
    """fn over a batch part: a tensor or array, or a list of them per
    task."""
    return [fn(p) for p in part] if isinstance(part, list) else fn(part)


def compare_f32_step(batch, dev, n=F32_BATCH, three_d=False,
                     multitask=False):
    """One float32 step on the first n elements of `batch` (of each task's
    batch with multitask) on the card (TF32 off) and on the host from the
    same weights and batch: loss within 1e-4 relative, BN running
    statistics within 1e-5, parameters within PARAM_TOL * lr for at least
    PARAM_SHARE of them and within 2 lr (opposite signs; 1e-3 of it for
    the rounding of p + u - p) for all."""
    X, y, w = (_batch_part(t, lambda p: p[:n]) for t in batch)
    lr = 5e-5
    out = {}
    for name, d in (("card", dev), ("host", torch.device("cpu"))):
        model, opt, step = fresh_step(torch.float32, d, lr, three_d=three_d,
                                      multitask=multitask)
        before = opt.packed.data.detach().cpu().clone()
        t0 = time.perf_counter()
        loss = step(_batch_part(X, lambda p: p.to(d)),
                    _batch_part(y, lambda p: p.to(d)), w)["loss"].item()
        secs = time.perf_counter() - t0
        stats = {k: v.cpu() for k, v in model.state_dict().items()
                 if k.endswith(("running_mean", "running_var"))}
        out[name] = (loss, stats, opt.packed.data.cpu() - before, secs)
        del model, opt, step
    (l_c, s_c, d_c, t_c), (l_h, s_h, d_h, t_h) = out["card"], out["host"]
    rel = abs(l_c - l_h) / abs(l_h)
    stat_err = max((s_c[k] - s_h[k]).abs().max().item() for k in s_c)
    diff = (d_c - d_h).abs()
    share = (diff <= PARAM_TOL * lr).float().mean().item()
    what = "3D " if three_d else "multi-task " if multitask else ""
    log(f"f32 {what}train step, batch {n}{' per task' if multitask else ''}"
        f", card vs host: loss "
        f"{l_c:.7f} vs {l_h:.7f} (rel {rel:.3g} <= 1e-4); BN running stats "
        f"max abs err {stat_err:.3g} (<= 1e-5); parameter updates within "
        f"{PARAM_TOL} lr: {100 * share:.4f}% (>= {100 * PARAM_SHARE}%), max "
        f"diff {diff.max().item() / lr:.4g} lr (<= 2, opposite signs, plus "
        f"rounding); host step "
        f"{t_h:.1f} s")
    if not (rel <= 1e-4 and stat_err <= 1e-5 and share >= PARAM_SHARE
            and diff.max().item() <= 2 * lr * (1 + 1e-3)):
        raise AssertionError("f32 train step on the card disagrees with the "
                             "host")


def sampler_parts(train_seq, n_batches):
    """Host wall ms per batch of train_seq.__getitem__ on the per-image
    path (ending in a synchronisation), then, over as many more batches,
    of its parts:
    candidate label gather + presence fetch, image plane gather, elastic
    augmentation, each timed between synchronisations (which slow the
    whole, so the parts come from batches of their own)."""
    train_seq[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_batches):
        train_seq[i]
    torch.cuda.synchronize()
    total = (time.perf_counter() - t0) / n_batches * 1e3

    parts = {"candidates + presence fetch": 0.0, "plane gather": 0.0,
             "elastic": 0.0}

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = fn(*args, **kwargs)
            torch.cuda.synchronize()
            parts[name] += time.perf_counter() - t0
            return result
        return wrapper

    originals = (multi_planar.candidate_label_slices,
                 multi_planar.sample_plane)
    multi_planar.candidate_label_slices = timed(
        "candidates + presence fetch", originals[0])
    multi_planar.sample_plane = timed("plane gather", originals[1])
    train_seq.augment = timed("elastic", train_seq.augment)
    try:
        for i in range(n_batches):
            train_seq[i]
    finally:
        multi_planar.candidate_label_slices, multi_planar.sample_plane = \
            originals
        del train_seq.augment
    return total, {k: v / n_batches * 1e3 for k, v in parts.items()}


# ------------------------------------------------------------ pooled sampler
# The sampler A/B: AB_ROUNDS rounds of AB_BATCHES batches per path on one
# sequence, the two paths alternating. The card-vs-CPU gate: CPU_BATCHES
# pooled batches without augmenters from one numpy seed, images within
# CPU_IMAGE_TOL of the largest |intensity|, labels equal on CPU_LABEL_SHARE
# of pixels, weights equal. The pooled eviction run: EVICT_BATCHES batches
# of EVICT_BATCH over a LimitationQueue of EVICT_LOADED images, each
# swapped out after EVICT_ACCESS accesses. The bounded `mp train`: its
# LimitationQueue holds BOUNDED_LOADED images (below the batch of 16, so
# the per-image path), 1 epoch of 2 steps.
AB_ROUNDS, AB_BATCHES = 3, 8
CPU_BATCHES, CPU_IMAGE_TOL, CPU_LABEL_SHARE = 3, 1e-5, 0.9999
EVICT_LOADED, EVICT_ACCESS, EVICT_BATCH, EVICT_BATCHES = 2, 3, 2, 12
BOUNDED_LOADED = 2
BOUNDED_ARGS = ["--max_loaded_images", str(BOUNDED_LOADED), "--num_access",
                "4", "--epochs", "1", "--train_images_per_epoch", "32",
                "--val_images_per_epoch", "16"]


def set_sampler_path(seq, pooled):
    """Sample the batches that follow on the pooled (True) or the
    per-image path of `seq`."""
    seq.use_pool = pooled
    seq._path_chosen = True


def check_batch_contract(seq, batch, what):
    """Labels in [0, n_classes) and at least n_fg_slices planes holding a
    foreground class; returns the count of such planes."""
    labs = batch[1].detach().cpu().numpy()
    n_fg = int(sum(np.isin(el, seq.fg_classes).any() for el in labs))
    if not (labs.min() >= 0 and labs.max() < seq.n_classes
            and n_fg >= seq.n_fg_slices):
        raise AssertionError(
            f"{what}: labels in [{labs.min()}, {labs.max()}] (n_classes "
            f"{seq.n_classes}), {n_fg} fg planes (quota {seq.n_fg_slices})")
    return n_fg


def staged_sampler_bytes(seq):
    """Device bytes of the per-image path's staged copies (volumes and
    labels held by the images' samplers)."""
    n = 0
    for image in seq.image_pair_queue.dataset.images:
        sampler = image._interpolator
        for staged in (getattr(sampler, "_staged", None),
                       getattr(sampler, "_labels_staged", None)):
            if staged is not None:
                n += staged[1].numel() * staged[1].element_size()
    return n


def pooled_sampler_parts(seq, n_batches):
    """Host wall ms per pooled batch of its parts, each between
    synchronisations: start (queue draws, pool staging, the numpy draws),
    the depth-0 candidate gather with its presence, the phase-2 gather of
    the rows the rules may reject with theirs (each presence fetch follows
    its synchronised gather), the chosen-plane gather, Elastic2D; the rest
    is the host walk, the fetches and the label selection."""
    names = ("start: draws + staging", "depth-0 gather + fetch",
             "phase-2 gather + fetch", "chosen-plane gather", "elastic")
    parts = dict.fromkeys(names, 0.0)
    in_start = [False]

    def timed(fn, name_of):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            name = name_of(*args, **kwargs)
            if name:
                parts[name] += time.perf_counter() - t0
            return out, time.perf_counter() - t0
        return wrapper

    cand = timed(multi_planar.pool_candidate_labels, lambda *a, **k: (
        "depth-0 gather + fetch" if in_start[0] else "phase-2 gather + fetch"))
    chosen = timed(multi_planar.sample_plane_batch_pool, lambda *a, **k: (
        "chosen-plane gather" if k.get("method", "linear") == "linear"
        else None))
    start = timed(seq._start_pooled_batch, lambda: None)
    augment = timed(seq.augment, lambda *a, **k: "elastic")
    depth0 = [0.0]

    def cand_wrapper(*args, **kwargs):
        out, secs = cand(*args, **kwargs)
        if in_start[0]:
            depth0[0] += secs
        return out

    def start_wrapper():
        in_start[0] = True
        try:
            st, secs = start()
        finally:
            in_start[0] = False
        parts["start: draws + staging"] += secs
        return st

    originals = (multi_planar.pool_candidate_labels,
                 multi_planar.sample_plane_batch_pool)
    multi_planar.pool_candidate_labels = cand_wrapper
    multi_planar.sample_plane_batch_pool = lambda *a, **k: chosen(*a, **k)[0]
    seq._start_pooled_batch = start_wrapper
    seq.augment = lambda *a, **k: augment(*a, **k)[0]
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n_batches):
            seq[i]
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) / n_batches * 1e3
    finally:
        (multi_planar.pool_candidate_labels,
         multi_planar.sample_plane_batch_pool) = originals
        del seq._start_pooled_batch, seq.augment
    # the depth-0 gather runs inside start: count it once
    parts["start: draws + staging"] -= depth0[0]
    out = {k: v / n_batches * 1e3 for k, v in parts.items()}
    out["rest: walk, fetches, selection"] = total - sum(out.values())
    return total, out


def sampler_ab(seq, rounds, n):
    """Host wall ms per batch of the pooled and the per-image path of one
    sequence, in alternating rounds of n batches with a synchronisation
    before and after each: {path: [ms per batch of each round]}, and the
    peak allocated bytes above the resident ones during each path's
    rounds."""
    ms = {"pooled": [], "per-image": []}
    peak = dict.fromkeys(ms, 0)
    for r in range(rounds):
        order = ("pooled", "per-image") if r % 2 == 0 else ("per-image",
                                                            "pooled")
        for path in order:
            set_sampler_path(seq, path == "pooled")
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for i in range(n):
                seq[i]
            torch.cuda.synchronize()
            ms[path].append((time.perf_counter() - t0) / n * 1e3)
            peak[path] = max(peak[path],
                             torch.cuda.max_memory_allocated() - base)
    set_sampler_path(seq, True)
    return ms, peak


def pool_build_blocks(seq):
    """Build `seq`'s pool on the card with the caching allocator's history
    on. Returns (the pool, the bytes asked by the allocations made under
    `_get_pool` and live after it, the bytes of the blocks that the
    allocator handed them, the other allocations made while it was built
    and live after it as (bytes asked, innermost Python frame) pairs).
    `memory_allocated`'s growth over the build is no measure of the pool:
    another thread may allocate meanwhile, and the allocator hands out a
    free block whole when it is at most 1 MB larger than asked (a free
    block in a segment still in use survives `empty_cache`), so two runs
    saw it 1536 B above the pool. The bytes are therefore attributed by
    the allocating stack, and the pool's tensors must be allocations of
    its build."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.memory._record_memory_history(
        enabled="all", context="alloc", stacks="python", clear_history=True)
    try:
        pool = seq._get_pool()
        torch.cuda.synchronize()
        snapshot = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    block_bytes = {}
    for seg in snapshot["segments"]:
        addr = seg["address"]
        for b in seg["blocks"]:
            block_bytes[addr] = b["size"]
            addr += b["size"]
    live = {}  # a trace event's size is the bytes asked
    for e in snapshot["device_traces"][torch.cuda.current_device()]:
        if e["action"] == "alloc":
            live[e["addr"]] = e
        elif e["action"] == "free_requested":
            live.pop(e["addr"], None)
    asked = blocks = 0
    own, foreign = set(), []
    for addr, e in live.items():
        frames = e.get("frames", [])
        if any(f["name"] == "_get_pool" for f in frames):
            asked += e["size"]
            blocks += block_bytes[addr]
            own.add(addr)
        else:
            foreign.append((e["size"], next(
                (f"{Path(f['filename']).name}:{f['line']} {f['name']}"
                 for f in frames), "no Python frame")))
    ptrs = {t.data_ptr() for t in (pool.volumes, pool.labels)}
    if ptrs != own:
        raise AssertionError(f"the pool's tensors at {sorted(ptrs)} are not "
                             f"the allocations of its build {sorted(own)}")
    return pool, asked, blocks, foreign


def check_pooled_card_vs_cpu(seq, n_batches, card):
    """Pooled batches of copies of `seq` on the card and on the CPU (own
    pools, no augmenters: the warp's blur sums in another order on each,
    so phase_threefry holds an Elastic2D batch card vs CPU at its own
    tolerance) from the same numpy seed: images within CPU_IMAGE_TOL of
    the largest |intensity|, labels equal on CPU_LABEL_SHARE of pixels,
    weights equal, and the batch contract. Gates the card pool's bytes: the bytes that
    building it allocated (`pool_build_blocks`), equal to capacity x
    padded shape x (C x 4 + label itemsize). Returns the card pool's
    bytes."""
    batches, pools = {}, {}
    for name, device in (("card", seq.device), ("cpu", torch.device("cpu"))):
        s = copy.copy(seq)
        s.device, s._pool, s.list_of_augmenters = device, None, None
        set_sampler_path(s, True)
        s.seed = lambda: None  # one numpy seed for both
        if device.type == "cuda":
            pools[name], built, blocks, foreign = pool_build_blocks(s)
        else:
            pools[name] = s._get_pool()
        np.random.seed(1234)
        batches[name] = [s[i] for i in range(n_batches)]
        for i, b in enumerate(batches[name]):
            check_batch_contract(s, b, f"pooled batch {i} on the {name}")
    pool = pools["card"]
    want = (pool.capacity * int(np.prod(pool.shape))
            * (pool.n_channels * 4 + pool.labels.element_size()))
    if not pool.nbytes == want == built:
        raise AssertionError(f"pool bytes {pool.nbytes}, allocated by its "
                             f"build {built}, want {want}")
    img_err, label_share = 0.0, 1.0
    for (cX, cy, cw), (hX, hy, hw) in zip(batches["card"], batches["cpu"]):
        hX = hX.numpy()
        img_err = max(img_err, float(np.abs(cX.cpu().numpy() - hX).max()
                                     / max(1.0, np.abs(hX).max())))
        label_share = min(label_share, float(
            (cy.cpu().numpy() == hy.numpy()).mean()))
        if not np.array_equal(cw, hw):
            raise AssertionError("pooled weights differ card vs CPU")
    log(f"[{card}] pooled batches card vs CPU ({n_batches} batches of "
        f"{seq.batch_size}, one numpy seed, no augmenters): images max abs "
        f"err {img_err:.3g} of the largest |intensity| (<= {CPU_IMAGE_TOL}), "
        f"labels equal on {label_share:.6f} of pixels (>= "
        f"{CPU_LABEL_SHARE}), weights equal; every batch meets the fg quota "
        f"({seq.n_fg_slices} of {seq.batch_size}) with labels in [0, "
        f"{seq.n_classes}); pool {pool.capacity} slots of "
        f"{pool.shape + (pool.n_channels,)} float32 + "
        f"{str(pool.labels.dtype).split('.')[-1]} labels = {pool.nbytes} B "
        f"({pool.nbytes / 2**30:.3f} GiB), allocated by its build {built} "
        f"B in blocks of {blocks} B; allocated meanwhile by other code "
        f"{foreign or 'nothing'}")
    if not (img_err <= CPU_IMAGE_TOL and label_share >= CPU_LABEL_SHARE):
        raise AssertionError("pooled batches differ card vs CPU")
    del pools, batches
    return pool.nbytes


def phase_sampler(train_seq, card):
    """The pooled sampler against the per-image path on the in-process
    train-256 sequence (batch 16, Elastic2D on): the pooled path builds no
    per-image staged copies (gate), its parts, the A/B, the card-vs-CPU
    gate; then the per-image path's parts. Returns (pooled median ms per
    batch, the per-image (ms, parts))."""
    set_sampler_path(train_seq, True)
    train_seq[0]
    staged = staged_sampler_bytes(train_seq)
    if staged:
        raise AssertionError(f"the pooled path staged {staged} B of "
                             f"per-image copies")
    pool_ms, pool_parts = pooled_sampler_parts(train_seq, 8)
    set_sampler_path(train_seq, False)
    train_seq[0]  # stage the per-image copies before the A/B
    staged = staged_sampler_bytes(train_seq)
    ab, peak = sampler_ab(train_seq, AB_ROUNDS, AB_BATCHES)
    med = {k: float(np.median(v)) for k, v in ab.items()}
    log(f"[{card}] sampler A/B, batch {train_seq.batch_size}, dim "
        f"{train_seq.sample_dim}, Elastic2D on, {AB_ROUNDS} alternating "
        f"rounds of {AB_BATCHES} batches each: "
        + "; ".join(f"{k} median {med[k]:.2f} ms per batch (rounds "
                    f"{min(v):.2f}-{max(v):.2f}: "
                    f"{[round(x, 2) for x in v]}), peak {peak[k] / 2**20:.1f} "
                    f"MiB above the resident" for k, v in ab.items())
        + f"; per-image / pooled {med['per-image'] / med['pooled']:.2f}x; "
        f"resident: pool {train_seq._pool.nbytes / 2**20:.1f} MiB, "
        f"per-image staged copies {staged / 2**20:.1f} MiB")
    log(f"[{card}] pooled sampler parts (batch {train_seq.batch_size}, "
        f"each between synchronisations, mean of 8): {pool_ms:.2f} ms per "
        f"batch in all; "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in pool_parts.items()))
    check_pooled_card_vs_cpu(train_seq, CPU_BATCHES, card)
    set_sampler_path(train_seq, False)
    per_image = sampler_parts(train_seq, 8)
    for image in train_seq.image_pair_queue.dataset.images:
        image.interpolator.unload_device()
    set_sampler_path(train_seq, True)
    return med["pooled"], per_image


def phase_pooled_eviction(proj, dev, card):
    """The pooled path with LRU eviction: the train-256 subjects through a
    LimitationQueue of EVICT_LOADED images (swapped after EVICT_ACCESS
    accesses) at batch EVICT_BATCH, through
    `prepare_for_multi_view_unet` with fit.max_loaded set, no augmenters.
    Gates: the pooled path with EVICT_LOADED slots, the batch contract on
    every batch, at most EVICT_LOADED images loaded at any access, more
    images staged than slots (evictions), no per-image staged copies."""
    t0 = time.perf_counter()
    hparams = YAMLHParams(proj / "train_hparams.yaml", no_log=True,
                          no_version_control=True)
    hparams["fit"].update(max_loaded=EVICT_LOADED, num_access=EVICT_ACCESS,
                          batch_size=EVICT_BATCH, augmenters=None)
    seq, _ = prepare_for_multi_view_unet(
        hparams, no_val=True, continue_training=True,
        logger=ScreenLogger(False), base_path=str(proj), device=dev)
    queue = seq.image_pair_queue
    if not isinstance(queue, LimitationQueue):
        raise AssertionError(f"fit.max_loaded built a {type(queue).__name__}")
    pool = seq._get_pool()
    loaded, staged = [], []
    ensure = pool.ensure

    def counting(image):
        loaded.append(queue.dataset.n_loaded)
        if image.identifier not in pool._slot_of:
            staged.append(image.identifier)
        return ensure(image)
    pool.ensure = counting
    try:
        n_fg = [check_batch_contract(seq, seq[i], f"eviction batch {i}")
                for i in range(EVICT_BATCHES)]
    finally:
        queue.loading_pool.join()
        queue.loading_pool.de_register_dataset(queue.dataset.identifier)
    per_image = staged_sampler_bytes(seq)
    log(f"[{card}] pooled eviction run: {EVICT_BATCHES} batches of "
        f"{EVICT_BATCH} over a LimitationQueue (max_loaded {EVICT_LOADED}, "
        f"num_access {EVICT_ACCESS}) of {len(queue.dataset)} subjects, "
        f"pooled {seq.use_pool} with {pool.capacity} slots: {len(staged)} "
        f"stagings of {len(set(staged))} subjects, loaded at each access "
        f"max {max(loaded)} (<= {EVICT_LOADED}), fg planes per batch "
        f"{n_fg}, per-image staged copies {per_image} B; "
        f"{time.perf_counter() - t0:.1f} s")
    if not (seq.use_pool and pool.capacity == EVICT_LOADED
            and len(loaded) == EVICT_BATCHES * EVICT_BATCH
            and max(loaded) <= EVICT_LOADED
            and len(staged) > EVICT_LOADED and per_image == 0):
        raise AssertionError("the pooled eviction run failed its gates")


def run_bounded_mp_train(proj, dev, root, card):
    """`mp train --max_loaded_images 2 --num_access 4` in a subprocess on
    the train-256 project's YAML, copied into a project of its own (the
    trained project stays as it is): the per-image path over a
    LimitationQueue (2 slots are below the batch of 16). Gates: exit 0,
    the queue and the path in its log, at least one reload logged, one
    CSV row with a finite loss."""
    bproj = root / "bounded_project"
    bproj.mkdir()
    shutil.copy(proj / "train_hparams.yaml", bproj / "train_hparams.yaml")
    wall, _ = run_mp_script(
        ["train", "--project_dir", str(bproj), "--device", str(dev),
         "--overwrite", "--no_images", *BOUNDED_ARGS], timeout=600)
    text = (bproj / "logs" / "train.txt").read_text()
    reloads = text.count("Reload: unloaded")
    lines = (bproj / "logs" / "training.csv").read_text().splitlines()
    row = dict(zip(lines[0].split(","), lines[-1].split(",")))
    log(f"[{card}] mp train {' '.join(BOUNDED_ARGS)}: {wall:.1f} s wall, "
        f"{reloads} reloads logged, CSV rows {len(lines) - 1} (loss "
        f"{row.get('loss')}, val_dice {row.get('val_dice')})")
    want = (f"Sampler: per-image path (volume pool capacity {BOUNDED_LOADED} "
            f"< batch size {BATCH})")
    if not ("'Limitation' queue created" in text and want in text
            and reloads >= 1 and len(lines) == 2
            and np.isfinite(float(row["loss"]))):
        raise AssertionError("the bounded mp train failed its gates")


def phase_training(dev, tmp, card):
    """`mp train` end to end at the bench model's full width on the pooled
    sampler (gates in check_trained_project and run_mp_train), the step
    checks (f32 card vs host, bf16 vs f32, overfit), the sampler's paths
    (phase_sampler), the training numbers, the pooled path with eviction
    and the bounded-memory `mp train`. Returns (the trained project, its
    data folders)."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    root = Path(tmp) / "train"
    proj, dirs = write_train_project(root, dev)
    log(f"training project written in {time.perf_counter() - t_phase:.1f} s")
    wall, epochs = run_mp_train(proj, dev)
    check_trained_project(proj, tmp)
    hparams = YAMLHParams(proj / "train_hparams.yaml", no_log=True)

    # In-process sequences over the trained project (its views)
    train_seq, val_seq = prepare_for_multi_view_unet(
        hparams, continue_training=True, logger=ScreenLogger(False),
        base_path=str(proj), device=dev)
    train_seq.batch_size = val_seq.batch_size = BATCH
    batches = [train_seq[i] for i in range(4)]
    compare_f32_step(batches[0], dev)

    # bf16 vs f32 loss of the same first step (batch 16)
    losses = {}
    for dtype in (torch.float32, torch.bfloat16):
        _, _, step = fresh_step(dtype, dev, 5e-5)
        losses[dtype] = step(*batches[0])["loss"].item()
        del step
    rel = abs(losses[torch.bfloat16] - losses[torch.float32]) / abs(
        losses[torch.float32])
    log(f"bf16 vs f32 train step loss (batch {BATCH}): "
        f"{losses[torch.bfloat16]:.6f} vs {losses[torch.float32]:.6f}, rel "
        f"{rel:.3g} (<= 2e-2)")
    if rel > 2e-2:
        raise AssertionError("bf16 step loss too far from the f32 one")

    # Overfit one batch
    model, _, step = fresh_step(torch.bfloat16, dev, 1e-3)
    curve = [step(*batches[0])["loss"].item() for _ in range(OVERFIT_STEPS)]
    log(f"overfit one batch, {OVERFIT_STEPS} bf16 Adam steps at lr 1e-3: "
        f"loss {curve[0]:.4f} -> {curve[-1]:.4f} (ratio "
        f"{curve[-1] / curve[0]:.3f} < {OVERFIT_RATIO}); every 10th "
        f"{[round(v, 4) for v in curve[::10]]}")
    if not curve[-1] < OVERFIT_RATIO * curve[0]:
        raise AssertionError("the bf16 train step does not fit one batch")

    # Numbers: the step alone at batch 16 and 64, the sampler, validation
    model, _, step = fresh_step(torch.bfloat16, dev, 5e-5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    med, q1, q3 = step_time_ms(step, batches, warmup=5, timed=20)
    peak16 = torch.cuda.max_memory_allocated(dev)
    split = step_split_ms(step, batches, warmup=2, timed=10)
    busy, table = profile_steps(step, batches)
    model.eval()
    fwd_flops = unet_flops_per_plane(model, dev)
    model.train()
    tflops = 3 * fwd_flops * BATCH / (med * 1e-3) / 1e12
    big = tuple(torch.cat([b[i] for b in batches]) if i < 2
                else np.concatenate([b[2] for b in batches])
                for i in range(3))
    del step, model
    torch.cuda.empty_cache()
    model, _, step = fresh_step(torch.bfloat16, dev, 5e-5)
    torch.cuda.reset_peak_memory_stats(dev)
    med64, q1_64, q3_64 = step_time_ms(step, [big], warmup=2, timed=5)
    peak64 = torch.cuda.max_memory_allocated(dev)
    del step, model, big
    torch.cuda.empty_cache()
    pooled_ms, (samp_ms, parts) = phase_sampler(train_seq, card)

    model, _, _ = fresh_step(torch.bfloat16, dev, 5e-5)
    trainer = Trainer(model, logger=ScreenLogger(False), device=dev)
    trainer.compile_model("Adam", {"lr": 5e-5}, "SparseCategoricalCrossentropy",
                          ["sparse_categorical_accuracy"])
    val_cb = Validation(val_seq, VAL_IMAGES // BATCH, verbose=False)
    val_cb.set_trainer(trainer)
    val_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        val_cb.on_epoch_end(0, {})
        val_ms.append((time.perf_counter() - t0) * 1e3)
    del trainer, model, val_cb

    steps = TRAIN_IMAGES // BATCH
    loop = [e[0] for e in epochs[1:]]
    steady = float(np.mean(loop))
    step_sum = steps * med / 1e3
    exposed = max(0.0, steady - step_sum)
    hidden = 1.0 - min(1.0, exposed / (steps * pooled_ms / 1e3))
    log(f"[{card}] train step (bf16, batch {BATCH}, full width, dim {DIM}): "
        f"median {med:.2f} ms (quartiles {q1:.2f} / {q3:.2f}) over 20 steps "
        f"after 5 warm-up, CUDA events around the step alone; peak "
        f"allocated {peak16 / 2**30:.2f} GiB; {fwd_flops / 1e9:.1f} GFLOP "
        f"forward per plane, step at 3x forward (an approximation) = "
        f"{tflops:.1f} TFLOP/s ({100 * tflops / 989:.1f}% of 989 dense bf16 "
        f"TFLOP/s)")
    log(f"[{card}] train step parts (mean of 10, CUDA events): "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in split.items())
        + f"; torch.profiler: device busy {busy:.2f} ms per step of "
        f"{med:.2f} ms ({100 * busy / med:.1f}%), kernels by self device "
        f"time over 3 steps:\n{table}")
    log(f"[{card}] train step at batch {BATCH_LARGE}: median {med64:.2f} ms "
        f"(quartiles {q1_64:.2f} / {q3_64:.2f}, 5 steps after 2 warm-up), "
        f"{BATCH_LARGE / (med64 * 1e-3):.1f} images/s of step time; peak "
        f"allocated {peak64 / 2**30:.2f} GiB")
    log(f"[{card}] sampler (per-image path, batch {BATCH}, Elastic2D on): "
        f"{samp_ms:.1f} ms host wall per batch; parts, each between "
        f"synchronisations, "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in parts.items()))
    log(f"[{card}] validation epoch ({VAL_IMAGES // BATCH} steps of "
        f"{BATCH}): {val_ms[-1]:.1f} ms (first {val_ms[0]:.1f} ms)")
    log(f"[{card}] mp train: {wall:.1f} s wall for {TRAIN_EPOCHS} epochs; "
        f"train loop per epoch {[round(e[0], 3) for e in epochs]} s, "
        f"callbacks incl. validation {[round(e[1], 3) for e in epochs]} s; "
        f"steady epoch {steady:.3f} s vs {steps} x step median = "
        f"{step_sum:.3f} s: {exposed:.3f} s exposed of "
        f"{steps * pooled_ms / 1e3:.3f} s of pooled sampling "
        f"({100 * hidden:.1f}% hidden by the prefetch); "
        f"{steps * BATCH / steady:.1f} images/s")
    phase_pooled_eviction(proj, dev, card)
    run_bounded_mp_train(proj, dev, root, card)
    log(f"training phase: {time.perf_counter() - t_phase:.1f} s")
    return proj, dirs, epochs


# ----------------------------------------------------- callbacks and tools
# `mp train` of a copy of train-256's project with the QuantileTransformer
# scaler and the callbacks configured by name (MemoryConsumption before
# the CSVLogger, so that memory_gib is a CSV column; Profiler on epoch 1):
# 2 epochs of 10 steps of 16 and 2 validation steps
CB_EPOCHS, CB_IMAGES, CB_VAL_IMAGES = 2, 160, 32
CB_CALLBACKS = (
    "{class_name: MemoryConsumption}, {class_name: DividerLine}, "
    "{class_name: LearningCurve}, {class_name: FGBatchBalancer}, "
    "{class_name: MeanReduceLogArrays}, "
    "{class_name: PrintLayerWeights, kwargs: {layer: encoder_L0}}, "
    "{class_name: SavePredictionImages}, {class_name: SaveOutputAs2DImage}, "
    "{class_name: Profiler, kwargs: {log_dir: logs/profile, epochs: [1]}}")
# What each plotting step warns where matplotlib cannot be imported, and
# the files it writes where it can
PLOT_WARNINGS = ("Could not save sample images", "Could not plot views",
                 "LearningCurve failed", "SavePredictionImages failed",
                 "SaveOutputAs2DImage failed")
PLOT_FILES = ("images/train_images.png", "views.png", "logs/curve.png",
              "images/epoch_001.png", "images/outputs/output_epoch_001.png")
SCALER_REPS = 1


def importable(name):
    import importlib.util

    return importlib.util.find_spec(name) is not None


def write_callbacks_project(proj, root):
    """A copy of the trained train-256 project's YAML (its data, the
    Auditor's values) with scaler QuantileTransformer and CB_CALLBACKS
    inserted before the CSVLogger."""
    out = root / "callbacks_project"
    out.mkdir()
    text = (proj / "train_hparams.yaml").read_text()
    for old, new in (('scaler: "RobustScaler"',
                      'scaler: "QuantileTransformer"'),
                     ("callbacks: [*RLOP, *MCP_CLEAN, *ES, *TIMER, *CSV]",
                      f"callbacks: [*RLOP, *MCP_CLEAN, *ES, *TIMER, "
                      f"{CB_CALLBACKS}, *CSV]")):
        if old not in text:
            raise AssertionError(f"train-256's YAML lacks {old!r}")
        text = text.replace(old, new)
    (out / "train_hparams.yaml").write_text(text)
    return out


def trace_kernels(path):
    """{kernel name: (total device us, launches)} of the CUDA kernel
    events of a torch.profiler Chrome trace."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    out = {}
    for e in events:
        if e.get("cat") == "kernel":
            us, n = out.get(e["name"], (0.0, 0))
            out[e["name"]] = (us + float(e.get("dur", 0.0)), n + 1)
    return out


def check_callbacks_training(proj, card):
    """Gates on the callbacks project's `mp train`: memory_gib in the CSV,
    the DividerLine, PrintLayerWeights (finite mean and std) and
    FGBalancer lines in the log, the Profiler's trace with CUDA kernel
    events, and per plotting step its PNG where matplotlib imports or its
    warning where it does not. Prints the trace's top five kernels and
    the epoch walls beside train-256's."""
    head = (proj / "logs" / "training.csv").read_text().splitlines()[0]
    if "memory_gib" not in head.split(","):
        raise AssertionError(f"training.csv lacks memory_gib: {head}")
    text = (proj / "logs" / "train.txt").read_text()
    weights = [line for line in text.splitlines()
               if line.startswith("[Weights/encoder_L0] mean=")]
    stats = [float(w.split("=")[1].split()[0]) for line in weights
             for w in line.split()[1:3]]
    if (text.count("-" * 60) < CB_EPOCHS or len(weights) != CB_EPOCHS
            or not np.all(np.isfinite(stats))
            or "[FGBalancer] fg_batch_fraction -> " not in text):
        raise AssertionError("mp train's log lacks the DividerLine, "
                             "PrintLayerWeights or FGBalancer lines")
    trace = proj / "logs" / "profile" / "trace_epoch_1.json"
    kernels = trace_kernels(trace)
    if not kernels:
        raise AssertionError(f"{trace} holds no CUDA kernel events")
    total = sum(us for us, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:5]
    log(f"[{card}] Profiler trace of epoch 1 ({trace.stat().st_size / 2**20:.1f}"
        f" MiB, {sum(n for _, n in kernels.values())} kernel launches, "
        f"{total / 1e3:.1f} ms of kernels), top five by total time:\n"
        + "\n".join(f"  {us / 1e3:9.2f} ms {n:6d}x  {name[:100]}"
                    for name, (us, n) in top))
    warnings = (proj / "logs" / "warnings.txt").read_text() if (
        proj / "logs" / "warnings.txt").exists() else ""
    if importable("matplotlib"):
        missing = [f for f in PLOT_FILES if not (proj / f).exists()]
        if missing:
            raise AssertionError(f"matplotlib imports, yet no {missing}")
        log(f"matplotlib imports here: {list(PLOT_FILES)} written")
    else:
        missing = [w for w in PLOT_WARNINGS if w not in warnings]
        if missing:
            raise AssertionError(f"no matplotlib, and no warning {missing}")
        log(f"matplotlib cannot be imported here: each plotting step logged "
            f"its warning ({', '.join(PLOT_WARNINGS)}) and training "
            f"finished")
    return weights


def check_predict_batch(trainer, dev, card):
    """Trainer.predict_batch on one batch of BATCH planes of DIM^2 against
    the eval-mode model's forward, its time over 10 calls and its peak;
    ValDiceScores on that batch against dice_all of the host argmax. Runs
    under a DeviceMonitor(interval_s=0.5), whose samples must lie between
    the bytes allocated when it started and the peak of the window."""
    from multiplanarunet_tpu_torch.callbacks.validation import ValDiceScores
    from multiplanarunet_tpu_torch.evaluate.metrics import dice_all
    from multiplanarunet_tpu_torch.utils.system import DeviceMonitor

    gen = torch.Generator(device=dev).manual_seed(3)
    X = torch.rand((BATCH, DIM, DIM, N_CHANNELS), generator=gen, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    floor = torch.cuda.memory_allocated(dev)
    lines = []
    monitor = DeviceMonitor(logger=lines.append, interval_s=0.5)
    t_start = time.perf_counter()
    probs = trainer.predict_batch(X)
    with torch.no_grad():
        trainer.model.eval()
        ref = trainer.model(X.movedim(-1, 1)).movedim(1, -1)
    diff = float((probs - ref).abs().max())
    base = torch.cuda.memory_allocated(dev)
    first_peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ms = cuda_ms(lambda: trainer.predict_batch(X), 10)
    peak = torch.cuda.max_memory_allocated(dev) - base
    # labels: the model's own classes on half the planes, random elsewhere
    host_cls = probs.argmax(-1).cpu().numpy()
    y = np.random.RandomState(4).randint(0, N_CLASSES, host_cls.shape)
    y[: BATCH // 2] = host_cls[: BATCH // 2]
    # one chunk of the whole batch: the argmax of the same forward as probs
    vds = ValDiceScores((X, y[..., None]), N_CLASSES, batch_size=BATCH)
    vds.set_trainer(trainer)
    got = float(vds.eval())
    want = float(np.nanmean(dice_all(y, host_cls, n_classes=N_CLASSES,
                                     ignore_zero=True)))
    while len(monitor.samples) < 2 and time.perf_counter() - t_start < 5:
        time.sleep(0.1)
    monitor.stop()
    top = max(first_peak, torch.cuda.max_memory_allocated(dev))
    log(f"[{card}] Trainer.predict_batch ({BATCH} planes of {DIM}^2, bf16 "
        f"U-Net, eval mode): {ms:.2f} ms per call (10 calls, CUDA events), "
        f"peak {peak / 2**30:.2f} GiB above the {base / 2**30:.2f} GiB "
        f"allocated; vs the eval-mode forward: max abs diff {diff:.3g}")
    log(f"ValDiceScores on that batch: {got:.6f}; dice_all of the host "
        f"argmax: {want:.6f}")
    log(f"DeviceMonitor(interval_s=0.5): {len(monitor.samples)} samples, "
        f"first line {lines[0] if lines else None!r}; allocated "
        f"{floor} bytes at its start, peak {top} in the window")
    if diff > 1e-6 or abs(got - want) > 1e-6:
        raise AssertionError("predict_batch or ValDiceScores disagrees")
    if not monitor.samples or not all(
            floor <= n <= top for _, _, n in monitor.samples):
        raise AssertionError(f"DeviceMonitor samples {monitor.samples} "
                             f"outside [{floor}, {top}]")
    return ms


def scaler_seconds(vol):
    """Host seconds of fit + transform of one volume per scaler
    (SCALER_REPS repetitions each, the numpy stream seeded), and gates on
    the QuantileTransformer's output: in [0, 1] and monotone in the
    input."""
    from multiplanarunet_tpu_torch.preprocessing.scaling import get_scaler

    out, secs = None, {}
    for name in ("QuantileTransformer", "RobustScaler"):
        secs[name] = []
        for _ in range(SCALER_REPS):
            np.random.seed(0)
            t0 = time.perf_counter()
            scaled = get_scaler(name).fit_transform(vol)
            secs[name].append(time.perf_counter() - t0)
            if name == "QuantileTransformer":
                out = scaled
    x = vol.reshape(-1)
    y = out.reshape(-1)
    idx = np.random.RandomState(5).choice(x.size, 2 ** 20, replace=False)
    order = np.argsort(x[idx], kind="stable")
    if (y.min() < 0 or y.max() > 1
            or np.any(np.diff(y[idx][order]) < 0)):
        raise AssertionError("QuantileTransformer output outside [0, 1] or "
                             "not monotone in the input")
    return secs


def phase_callbacks_tools(dev, tmp, proj, dirs, epochs_256, card):
    """The callbacks, the QuantileTransformer scaler and the tools at the
    bench model's full width: `mp train` of a copy of train-256's project
    (QuantileTransformer, the callbacks of CB_CALLBACKS; gates in
    check_callbacks_training), predict_batch, ValDiceScores, DeviceMonitor
    and describe_devices in-process, the analytic FLOPs against the hook
    count, the scaler's host seconds, `mp predict` of the val subject on
    the trained copy (shear path, 72 launches from 0), `mp trim_channels`
    on a 2-channel NIfTI, and `mp export_weights` -> `mp convert_weights`
    of the trained model where h5py imports (else both must raise an
    error naming h5py). Returns the shear-pass launches of the mp predict
    run."""
    from multiplanarunet_tpu_torch.utils.system import describe_devices

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    root = Path(tmp) / "callbacks"
    root.mkdir()
    cproj = write_callbacks_project(proj, root)
    wall, epochs = run_mp_train(cproj, dev, n_epochs=CB_EPOCHS,
                                images=CB_IMAGES, val_images=CB_VAL_IMAGES,
                                no_images=False)
    weights = check_callbacks_training(cproj, card)
    steps = CB_IMAGES // BATCH
    steps_256 = TRAIN_IMAGES // BATCH
    log(f"[{card}] mp train with QuantileTransformer and the callbacks: "
        f"{wall:.1f} s wall for {CB_EPOCHS} epochs of {steps} steps; train "
        f"loop per epoch {[round(e[0], 3) for e in epochs]} s "
        f"({[round(1e3 * e[0] / steps, 1) for e in epochs]} ms per step; "
        f"epoch 1 profiled), callbacks incl. validation "
        f"{[round(e[1], 3) for e in epochs]} s; train-256's epochs "
        f"{[round(e[0], 3) for e in epochs_256]} s of {steps_256} steps "
        f"({[round(1e3 * e[0] / steps_256, 1) for e in epochs_256]} ms per "
        f"step), callbacks {[round(e[1], 3) for e in epochs_256]} s; "
        f"{weights[-1]}")

    # In-process: predict_batch, ValDiceScores, DeviceMonitor, devices
    hparams = YAMLHParams(cproj / "train_hparams.yaml", no_log=True)
    model = load_unet_weights(
        build_model(hparams["build"], mixed_precision=True,
                    logger=ScreenLogger(False)),
        cproj / "model" / "model_weights.npz")
    trainer = Trainer(model, logger=ScreenLogger(False), device=dev)
    check_predict_batch(trainer, dev, card)
    described = describe_devices()
    if torch.cuda.get_device_name(0) not in described:
        raise AssertionError(f"describe_devices() {described!r}")
    log(f"describe_devices(): {described!r}")
    analytic = unet_forward_flops(DIM, N_CLASSES, depth=DEPTH,
                                  complexity_factor=CF)
    hooked = unet_flops_per_plane(model, dev)
    log(f"unet_forward_flops({DIM}, {N_CLASSES}, depth={DEPTH}, "
        f"complexity_factor={CF}) = {analytic:.0f}; hook count "
        f"{hooked}; difference {hooked - analytic:.0f}")
    if hooked != analytic:
        raise AssertionError("the analytic FLOPs differ from the hook count")
    del trainer, model
    torch.cuda.empty_cache()

    # The scaler's host cost on one 256^3 subject
    vol = nifti.load(dirs["val"] / "images" / "val_0.nii.gz").get_fdata()
    secs = scaler_seconds(vol[..., None])
    log(f"[{card}] host fit + transform of one {DIM}^3 subject "
        f"({SCALER_REPS} repetitions): "
        + "; ".join(f"{k} {[round(t, 3) for t in v]} s"
                    for k, v in secs.items())
        + "; the QuantileTransformer's output in [0, 1], monotone")

    # mp predict of the val subject on the trained copy
    views = np.load(cproj / "views.npz")["arr_0"]
    planner = MultiViewPredictor(None, sample_dim=DIM,
                                 real_space_span=float(
                                     hparams["fit"]["real_space_span"]),
                                 n_classes=N_CLASSES, device=dev)
    plans = view_plans(planner, Image(vol[..., None], np.eye(4)), views)
    timings, launches = run_mp_predict_counted(cproj, "pred_quantile", [],
                                               plans)
    if launches != 72 or len(timings) != 1:
        raise AssertionError(f"mp predict: {launches} shear-pass launches "
                             f"for {len(timings)} images (72 for one)")
    for image_id, t in timings.items():
        log(f"[{card}] mp predict (QuantileTransformer) {image_id}: host "
            f"load (decode + scale) {t['load']:.3f} s, predict_image "
            f"{t['predict']:.3f} s, save {t['save']:.3f} s; shear-pass "
            f"launches {launches}")

    # mp trim_channels on a 2-channel copy of the val image
    trim_dir = root / "trim"
    trim_dir.mkdir()
    two = np.stack([vol, 2.0 * vol], axis=-1).astype(np.float32)
    nifti.save(two, trim_dir / "val_0_2ch.nii", np.eye(4))
    t0 = time.perf_counter()
    port_mp.entry_func(["trim_channels", "--folder", str(trim_dir),
                        "--channels", "1"])
    kept = nifti.load(trim_dir / "val_0_2ch.nii").get_raw_data()
    if kept.shape != vol.shape or not np.array_equal(kept, two[..., 1]):
        raise AssertionError(f"trim_channels kept {kept.shape}")
    log(f"mp trim_channels: {two.shape} -> {kept.shape}, channel 1 kept "
        f"({time.perf_counter() - t0:.2f} s)")

    # mp export_weights -> mp convert_weights of the trained model
    npz = cproj / "model" / "model_weights.npz"
    h5, back = root / "weights.h5", root / "weights_back.npz"
    if importable("h5py"):
        port_mp.entry_func(["export_weights", "--weights", str(npz), "--out",
                            str(h5)])
        port_mp.entry_func(["convert_weights", "--h5", str(h5), "--out",
                            str(back)])
        with np.load(npz) as a, np.load(back) as b:
            keys = [k for k in a.files if k != "__meta__"]
            if sorted(keys) != sorted(k for k in b.files if k != "__meta__") \
                    or any(not np.array_equal(a[k], b[k]) for k in keys):
                raise AssertionError("export -> convert changed the weights")
        log(f"mp export_weights -> mp convert_weights: {len(keys)} arrays "
            f"back unchanged")
    else:
        for args in (["export_weights", "--weights", str(npz), "--out",
                      str(h5)],
                     ["convert_weights", "--h5", str(h5), "--out",
                      str(back)]):
            try:
                port_mp.entry_func(args)
            except ImportError as e:
                if "h5py" not in str(e):
                    raise
                log(f"mp {args[0]} without h5py: {e}")
            else:
                raise AssertionError(f"mp {args[0]} ran without h5py")
    log(f"callbacks and tools phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ------------------------------------------------------------------ 3D path
# `mp train` of the 3D preset on the training phase's 3 + 1 subjects: 2
# epochs of 10 steps of 16 boxes and 2 validation steps, Elastic3D on, the
# pooled sampler; the float32 card/host step on F32_BATCH_3D boxes
TRAIN_EPOCHS_3D, TRAIN_IMAGES_3D, VAL_IMAGES_3D = 2, 160, 32
F32_BATCH_3D = 1
# The oracle's boxes (oversampled, so that the nearest scatter leaves no
# voxel of a 1 mm grid untouched) and patches
ORACLE_BOX, ORACLE_BOX_DIM, ORACLE_PATCH = 40.0, 48, 32


def unet3d_flops_per_box(model, dev):
    """Forward FLOPs of one DIM_3D^3 box: 2 * MACs of every convolution,
    counted with forward hooks on one box."""
    flops = []

    def hook(mod, _, out):
        flops.append(2 * out[0, 0].numel() * mod.out_channels
                     * mod.in_channels * int(np.prod(mod.kernel_size)))

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, nn.Conv3d)]
    with torch.inference_mode():
        model(torch.zeros((1, N_CHANNELS) + (DIM_3D,) * 3, device=dev))
    for h in hooks:
        h.remove()
    return sum(flops)


def write_3d_project(root, data, val_dir):
    """A project made by the port's `mp init_project --model 3D` over the
    training phase's data folder: only n_classes given (the Auditor fills
    dim, real_box_dim, real_space_span and n_channels at `mp train`), the
    val subject as the test set."""
    port_mp.entry_func(["init_project", "--name", "train3d_project",
                        "--root", str(root), "--data_dir", str(data),
                        "--model", "3D"])
    proj = root / "train3d_project"
    text = (proj / "train_hparams.yaml").read_text()
    for old, new in ((f"base_dir: {data}/test", f"base_dir: {val_dir}"),
                     ("n_classes: Null", f"n_classes: {N_CLASSES}")):
        if old not in text:
            raise AssertionError(f"the 3D init_project YAML lacks {old!r}")
        text = text.replace(old, new)
    for want in ('model_class_name: "UNet3D"', "intrp_style: 'iso_live_3d'",
                 "dim: Null", "real_box_dim: Null", "Elastic3D",
                 "batch_size: 16", "depth: 3"):
        if want not in text:
            raise AssertionError(f"the 3D preset lacks {want!r}")
    (proj / "train_hparams.yaml").write_text(text)
    return proj


def check_3d_yaml(proj):
    """The Auditor's values written back by `mp train`: dim 64, and
    real_box_dim = 64 x the 25th-percentile voxel size (1 mm here)."""
    hp = YAMLHParams(proj / "train_hparams.yaml", no_log=True)
    dim, box = hp["build"]["dim"], hp["fit"]["real_box_dim"]
    span = hp["fit"]["real_space_span"]
    log(f"3D project after mp train: build.dim {dim}, fit.real_box_dim "
        f"{box}, fit.real_space_span {span}, n_channels "
        f"{hp['build']['n_channels']}")
    if dim != DIM_3D or box is None or abs(float(box) - DIM_3D) > 1e-6 \
            or span is None:
        raise AssertionError("the Auditor did not fill the 3D values")
    return hp


def check_unet3d_against_host(dev):
    """The full-width UNet3D on one DIM_3D^3 box on the card in float32
    (TF32 off) against the same glorot weights on the host."""
    ref = glorot_init(UNet3D(N_CLASSES, N_CHANNELS, DEPTH_3D, CF_3D),
                      seed=4).eval()
    card = copy.deepcopy(ref).to(dev)
    x = torch.from_numpy(np.random.RandomState(6).randn(
        1, N_CHANNELS, DIM_3D, DIM_3D, DIM_3D).astype(np.float32))
    t0 = time.perf_counter()
    with torch.inference_mode():
        want = ref(x)
        host_s = time.perf_counter() - t0
        got = card(x.to(dev)).cpu()
    err = (got - want).abs().max().item()
    log(f"UNet3D full width on one {DIM_3D}^3 box: card f32 vs host f32 max "
        f"abs err {err:.3g} (< 1e-4); host forward {host_s:.1f} s")
    if not err < 1e-4:
        raise AssertionError("UNet3D on the card disagrees with the host")


def phase_3d_oracle(dev):
    """pred_3D_iso and predict_3D_patches on the card with the one-hot
    oracle on a 64^3 label volume fed as its image: box coverage > 0.95 and
    accuracy > 0.9 on the interior (base tiling + 2x random rotated
    boxes), patch accuracy > 0.99 over the volume. Launches no shear
    pass."""
    lab = oracle_labels(64)
    nc = 4
    img = Image(lab.astype(np.float32)[..., None], np.eye(4))
    fn = unet_predict_fn(OneHotOracle(nc).to(dev), dev)
    quiet = ScreenLogger(False)
    iso = IsotrophicLiveViewSequence3D(
        None, real_box_dim=ORACLE_BOX, dim=ORACLE_BOX_DIM, batch_size=1,
        n_classes=nc, noise_sd=0.1, no_log=True, device=dev, logger=quiet)
    np.random.seed(3)
    sums = pred_3D_iso(fn, iso, img, extra_boxes="2x")
    interior = np.zeros(lab.shape, bool)
    interior[2:-2, 2:-2, 2:-2] = True
    covered = sums.sum(-1) > 0
    cls = sums.argmax(-1)
    cov = float(covered[interior].mean())
    acc = float((cls == lab)[interior & covered].mean())
    patches = PatchSequence3D(None, dim=ORACLE_PATCH, n_classes=nc,
                              batch_size=1, no_log=True, device=dev,
                              logger=quiet)
    pcls = predict_3D_patches(fn, patches, img, want_argmax=True)
    pacc = float((pcls == lab).mean())
    n_base = len(iso.base_placements(img))
    log(f"3D oracle 64^3: pred_3D_iso ({n_base} base + {2 * n_base} extra "
        f"boxes of {ORACLE_BOX:g} mm at {ORACLE_BOX_DIM}^3, noise_sd 0.1) "
        f"interior coverage {cov:.4f} (> 0.95), accuracy {acc:.4f} (> 0.9); "
        f"predict_3D_patches ({len(patches.base_corners(img))} patches of "
        f"{ORACLE_PATCH}^3) accuracy {pacc:.4f} (> 0.99), uint8 "
        f"{pcls.dtype == np.uint8}")
    if not (cov > 0.95 and acc > 0.9 and pacc > 0.99
            and pcls.dtype == np.uint8):
        raise AssertionError("3D oracle reconstruction failed")


def run_mp_predict_3d(proj, dev):
    """`mp predict_3D` in a subprocess on the trained 3D project over the
    256^3 val subject (box mode, --extra_boxes 2x). Gates: PRED.nii.gz of
    the image's shape with classes below N_CLASSES, results.csv and
    detailed.csv written, a finite mean dice. Returns (wall s, the numbers
    its log reports)."""
    wall, _ = run_mp_script(
        ["predict_3D", "--project_dir", str(proj), "--device", str(dev),
         "--overwrite", "--out_dir", "pred3d", "--extra_boxes", "2x"],
        timeout=600)
    out = proj / "pred3d"
    pred = nifti.load(out / "nii_files" / "val_0" /
                      "PRED.nii.gz").get_raw_data()
    if pred.shape != (DIM,) * 3 or pred.max() >= N_CLASSES:
        raise AssertionError(f"3D PRED {pred.shape} {pred.dtype}")
    for name in ("results.csv", "detailed.csv"):
        if not (out / "csv" / name).exists():
            raise AssertionError(f"mp predict_3D wrote no csv/{name}")
    results = ResultTable.read_csv(out / "csv" / "results.csv")
    dice = float(results.values[0, 0])
    text = (out / "predict_log.txt").read_text()
    boxes, numbers = 0, {}
    for line in text.splitlines():
        words = line.split()
        if " boxes in chunks of " in line:
            boxes += int(words[0])
        elif line.startswith("Timing val_0:"):
            numbers["seconds"] = {w.strip(":"): float(v) for w, v in zip(
                words[2::3], words[3::3])}
        elif "Peak device memory:" in line:
            numbers["peak_gib"] = float(words[-2])
    if not np.isfinite(dice) or boxes == 0 or "seconds" not in numbers:
        raise AssertionError(f"mp predict_3D: dice {dice}, {boxes} boxes, "
                             f"log numbers {numbers}")
    numbers.update(dice=dice, boxes=boxes, classes=np.bincount(
        pred.ravel(), minlength=N_CLASSES).tolist())
    return wall, numbers


def phase_3d(dev, tmp, data, dirs, card):
    """The 3D path at full width: the project from `mp init_project
    --model 3D`, `mp train` in a subprocess (gates in check_trained_project,
    check_3d_yaml and run_mp_train), the in-process step, sampler and
    correctness checks, the oracle (phase_3d_oracle) and `mp predict_3D` in
    a subprocess (run_mp_predict_3d). The in-process parts launch no shear
    pass (gated). Returns 0, the shear-pass launches of the in-process
    parts."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    root = Path(tmp) / "train3d"
    root.mkdir()
    proj = write_3d_project(root, data, dirs["val"])
    wall, epochs = run_mp_train(
        proj, dev, TRAIN_EPOCHS_3D, TRAIN_IMAGES_3D, VAL_IMAGES_3D,
        sampler="Sampler: pooled path (isotropic 3D boxes")
    check_trained_project(proj, tmp, TRAIN_EPOCHS_3D, three_d=True)
    hparams = check_3d_yaml(proj)
    t_train = time.perf_counter() - t_phase
    shear_pass.launches = 0

    # In-process: the pooled 3D sampler (Elastic3D on) and the step
    train_seq, _ = prepare_for_3d_unet(hparams, logger=ScreenLogger(False),
                                       base_path=str(proj), device=dev)
    train_seq.batch_size = BATCH
    batches = [train_seq[i] for i in range(2)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(4):
        batches.append(train_seq[i])
    torch.cuda.synchronize()
    samp_ms = (time.perf_counter() - t0) / 4 * 1e3
    X = batches[0][0]
    if X.shape != (BATCH,) + (DIM_3D,) * 3 + (N_CHANNELS,):
        raise AssertionError(f"3D batch {tuple(X.shape)}")
    for i, b in enumerate(batches):
        check_batch_contract(train_seq, b, f"3D pooled batch {i}")
    compare_f32_step(batches[0], dev, n=F32_BATCH_3D, three_d=True)
    check_unet3d_against_host(dev)
    check_pooled_card_vs_cpu(train_seq, 1, card)

    model, _, step = fresh_step(torch.bfloat16, dev, 5e-5, three_d=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    med, q1, q3 = step_time_ms(step, batches, warmup=3, timed=10)
    peak = torch.cuda.max_memory_allocated(dev)
    model.eval()
    fwd_flops = unet3d_flops_per_box(model, dev)
    predict = unet_predict_fn(model, dev)
    box_ms = cuda_ms(lambda: predict(X), 3) / BATCH
    del step, model, predict, batches, X
    torch.cuda.empty_cache()
    tflops = 3 * fwd_flops * BATCH / (med * 1e-3) / 1e12
    steps = TRAIN_IMAGES_3D // BATCH
    steady = epochs[-1][0]
    exposed = max(0.0, steady - steps * med / 1e3)
    log(f"[{card}] 3D train step (bf16, batch {BATCH} boxes of {DIM_3D}^3, "
        f"UNet3D cf {CF_3D:g}, depth {DEPTH_3D}, 64 filters): median "
        f"{med:.2f} ms (quartiles {q1:.2f} / {q3:.2f}) over 10 steps after 3 "
        f"warm-up, CUDA events around the step alone; peak allocated "
        f"{peak / 2**30:.2f} GiB; {fwd_flops / 1e9:.1f} GFLOP forward per "
        f"box, step at 3x forward = {tflops:.1f} TFLOP/s "
        f"({100 * tflops / 989:.1f}% of 989 dense bf16 TFLOP/s); U-Net "
        f"inference {box_ms:.2f} ms per box (bf16, chunks of {BATCH})")
    log(f"[{card}] 3D pooled sampler (batch {BATCH}, Elastic3D on): "
        f"{samp_ms:.1f} ms host wall per batch (4 batches, synchronised)")
    log(f"[{card}] 3D mp train: {wall:.1f} s wall for {TRAIN_EPOCHS_3D} "
        f"epochs; train loop per epoch {[round(e[0], 3) for e in epochs]} s, "
        f"callbacks incl. validation {[round(e[1], 3) for e in epochs]} s; "
        f"steady epoch {steady:.3f} s vs {steps} x step median = "
        f"{steps * med / 1e3:.3f} s: {exposed:.3f} s exposed "
        f"({100 * exposed / steady:.1f}% of the epoch); "
        f"{steps * BATCH / steady:.1f} boxes/s")

    phase_3d_oracle(dev)
    if shear_pass.launches != 0:
        raise AssertionError(f"the 3D path launched {shear_pass.launches} "
                             f"shear passes")
    launches = shear_pass.launches
    check_predict_single_3d(proj, hparams, dev, dirs, card)
    if shear_pass.launches != 0:
        raise AssertionError(f"predict_single (iso_live_3d) launched "
                             f"{shear_pass.launches} shear passes")
    p_wall, numbers = run_mp_predict_3d(proj, dev)
    secs = numbers["seconds"]
    log(f"[{card}] mp predict_3D on the {DIM}^3 val subject (box mode, "
        f"--extra_boxes 2x): {p_wall:.1f} s wall for the command; "
        f"{numbers['boxes']} boxes per volume; per volume: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in secs.items())
        + f"; U-Net about {numbers['boxes'] * box_ms / 1e3:.3f} s of it at "
        f"{box_ms:.2f} ms per box; peak device memory "
        f"{numbers.get('peak_gib', float('nan')):.2f} GiB; mean dice "
        f"{numbers['dice']:.4f} (2 epochs of training); classes "
        f"{numbers['classes']}")
    log(f"3D phase: {time.perf_counter() - t_phase:.1f} s (project + mp "
        f"train {t_train:.1f} s)")
    return launches


# ---------------------------------------------------------------- multi-task
# multitask-256: `mp train` of the MultiTask preset at full width (the
# shared encoder and two heads at cf 2, depth 4, bf16, Elastic2D, the pooled
# sampler, Adam 5e-5, batch 16 per task): task 1 on the training phase's
# 3 + 1 structured 256^3 subjects (7 classes, dim 256 given, as train-256),
# task 2 on 3 + 1 structured 192^3 subjects (4 classes, dim and classes left
# for the Auditor); 2 epochs of 10 steps and 2 validation steps, then one
# more epoch with --continue_training
MT_TASKS, DIM_T2, N_CLASSES_T2 = ["task_1", "task_2"], 192, 4
MT_CLASSES, MT_DIMS = [N_CLASSES, N_CLASSES_T2], [DIM, DIM_T2]
MT_EPOCHS, MT_IMAGES, MT_VAL_IMAGES = 2, 160, 32
# The --continue_training process: one more epoch of 2 steps
MT_CONTINUE_IMAGES, MT_CONTINUE_VAL_IMAGES = 32, 16


def multitask_param_counts(n_classes, cf=CF, depth=DEPTH, init_filters=64,
                           k=3):
    """(shared encoder, [each task's head]) parameter counts of the
    MultiTaskUNet2D from its layer shapes: a k x k conv holds k^2 cin cout
    + cout, a BatchNorm 2 c (scale, bias), the 2 x 2 up conv 4 cin cout +
    cout, the 1 x 1 out conv cin n + n."""
    s = float(np.sqrt(cf))

    def block(cin, f):
        return k * k * cin * f + f + k * k * f * f + f + 2 * f

    encoder, cin, filters = 0, N_CHANNELS, init_filters
    for _ in range(depth):
        f = int(filters * s)
        encoder += block(cin, f)
        cin, filters = f, filters * 2
    heads = []
    for nc in n_classes:
        fl, c = filters, cin
        f = int(fl * s)
        n, c = block(c, f), f
        for _ in range(depth):
            fl //= 2
            f = int(fl * s)
            n += 4 * c * f + f + 2 * f + block(2 * f, f)
            c = f
        heads.append(n + c * nc + nc)
    return encoder, heads


def write_multitask_project(root, dev, dirs):
    """The second task's 3 + 1 structured 192^3 subjects, and a project
    from the port's `mp init_project --model MultiTask` over the training
    phase's data folder (gate: both task YAMLs hold the folders passed
    in); task 1's test set is its val subject and its n_classes and dim
    are given; task 2 points at its own data, its dim and n_classes left
    for the Auditor. The main YAML is the preset's (gated)."""
    data2 = root / "data_t2"
    seed = 200
    for split, n in (("train", N_TRAIN_SUBJECTS), ("val", N_VAL_SUBJECTS)):
        for sub in ("images", "labels"):
            (data2 / split / sub).mkdir(parents=True)
        for i in range(n):
            vol, lab = structured_subject(dev, seed, DIM_T2, N_CLASSES_T2)
            seed += 1
            nifti.save(vol, data2 / split / "images" / f"t2_{split}_{i}.nii.gz",
                       np.eye(4))
            nifti.save(lab, data2 / split / "labels" / f"t2_{split}_{i}.nii.gz",
                       np.eye(4))
    data = dirs["train"].parent
    port_mp.entry_func(["init_project", "--name", "mt_project", "--root",
                        str(root), "--model", "MultiTask", "--data_dir",
                        str(data)])
    proj = root / "mt_project"
    main = (proj / "train_hparams.yaml").read_text()
    for want in ('model_class_name: "MultiTaskUNet2D"', "complexity_factor: 2",
                 "depth: 4", "batch_size: 16", "mixed_precision: True",
                 "Elastic2D", "lr: 5.0e-05", "intrp_style: 'iso_live'"):
        if want not in main:
            raise AssertionError(f"the MultiTask preset lacks {want!r}")
    edits = {
        "task_1": ((f"base_dir: {data}/test", f"base_dir: {dirs['val']}"),
                   ("n_classes: Null", f"n_classes: {N_CLASSES}"),
                   ("dim: Null", f"dim: {DIM}")),
        "task_2": ((f"base_dir: {data}/train", f"base_dir: {data2}/train"),
                   (f"base_dir: {data}/val", f"base_dir: {data2}/val"),
                   (f"base_dir: {data}/test", f"base_dir: {data2}/val"))}
    for task, pairs in edits.items():
        path = proj / f"{task}.yaml"
        hp = YAMLHParams(path, no_log=True, no_version_control=True)
        for split in ("train", "val", "test"):
            got = hp[f"{split}_data"]["base_dir"]
            if got != f"{data}/{split}":
                raise AssertionError(f"mp init_project wrote {task} "
                                     f"{split}_data base_dir {got!r}")
        text = hp.string_rep
        for old, new in pairs:
            if old not in text:
                raise AssertionError(f"{task}.yaml lacks {old!r}")
            text = text.replace(old, new)
        path.write_text(text)
    log(f"mp init_project --model MultiTask wrote {proj} with the data "
        f"folders passed in; task 2 on {data2}")
    return proj


def check_multitask_project(proj, tmp, n_epochs):
    """Gates on what the multi-task `mp train` wrote: n_epochs CSV rows
    with every loss and dice finite and the per-task columns; the
    checkpoints' top level (encoder, task_task_1, task_task_2) and their
    keys and shapes those of the build; the build group's per-task lists;
    both views_<task>.npz with 6 unit vectors. Returns the build group."""
    lines = (proj / "logs" / "training.csv").read_text().splitlines()
    head = lines[0].split(",")
    rows = [dict(zip(head, r.split(","))) for r in lines[1:]]
    if len(rows) != n_epochs:
        raise AssertionError(f"training.csv has {len(rows)} rows")
    for key in ("task_0/loss", "task_1/loss", "val_task_0/dice",
                "val_task_1/dice", "val_dice", "val_loss", "lr"):
        if key not in head:
            raise AssertionError(f"training.csv lacks {key}: {head}")
    for row in rows:
        for key, value in row.items():
            if ("loss" in key or "dice" in key) and \
                    not np.isfinite(float(value)):
                raise AssertionError(f"training.csv {key} = {value}")
    build = safe_load((proj / "train_hparams.yaml").read_text())["build"]
    if build["n_classes"] != MT_CLASSES or len(build["dim"]) != 2 \
            or build["dim"][0] != DIM or build["task_names"] != MT_TASKS:
        raise AssertionError(f"build group {build}")
    ref_path = Path(tmp) / "reference_multitask_build.npz"
    checkpoint.save_unet_weights(ref_path, build_model(
        build, logger=ScreenLogger(False)))
    with np.load(ref_path) as ref:
        want = {k: ref[k].shape for k in ref.files}
    files = ([proj / "model" / "model_weights.npz"]
             + sorted((proj / "model").glob("@epoch_*.npz"))[-1:])
    if len(files) != 2 or not files[0].exists():
        raise AssertionError(f"model files "
                             f"{sorted((proj / 'model').iterdir())}")
    for f in files:
        p, _, _ = checkpoint.load_weights(f)
        if set(p) != {"encoder", "task_task_1", "task_task_2"}:
            raise AssertionError(f"{f.name}: top-level keys {sorted(p)}")
        with np.load(f) as data:
            got = {k: data[k].shape for k in data.files if k != "__meta__"}
        if got != want:
            raise AssertionError(f"{f.name}: keys/shapes differ from the "
                                 f"build's")
    for task in MT_TASKS:
        views = np.load(proj / f"views_{task}.npz")["arr_0"]
        if views.shape != (N_VIEWS, 3) or not np.allclose(
                np.linalg.norm(views, axis=1), 1.0, atol=1e-6):
            raise AssertionError(f"views_{task}.npz {views.shape}")
    log(f"multi-task mp train wrote: training.csv rows "
        f"{[r['epoch'] for r in rows]} (loss {[r['loss'] for r in rows]}, "
        f"val_task_0/dice {[r['val_task_0/dice'] for r in rows]}, "
        f"val_task_1/dice {[r['val_task_1/dice'] for r in rows]}); build "
        f"n_classes {build['n_classes']}, dim {build['dim']}; "
        f"{[f.name for f in files]} with the {len(want)} keys and shapes of "
        f"the build (encoder, task_task_1, task_task_2); views_task_1.npz and "
        f"views_task_2.npz ({N_VIEWS}, 3)")
    return build


def check_branches(proj, build):
    """`mp branch --copy_weights` in a subprocess: a folder per task whose
    YAML the port's reader reads as a UNet with its task's n_classes and
    dim, and model/ copied."""
    wall, _ = run_mp_script(["branch", "--project_dir", str(proj),
                             "--copy_weights"], timeout=300)
    branches = sorted(p.name for p in (proj / "branches").iterdir())
    if branches != MT_TASKS:
        raise AssertionError(f"mp branch wrote {branches}")
    for t, task in enumerate(MT_TASKS):
        hp = safe_load((proj / "branches" / task / "train_hparams.yaml")
                       .read_text())
        if (hp["build"]["model_class_name"] != "UNet"
                or hp["build"]["n_classes"] != MT_CLASSES[t]
                or hp["build"]["dim"] != build["dim"][t]):
            raise AssertionError(f"branch {task} build {hp['build']}")
        if not (proj / "branches" / task / "model" /
                "model_weights.npz").exists():
            raise AssertionError(f"branch {task} has no model/")
    log(f"mp branch --copy_weights: {wall:.1f} s; branches {branches}, each "
        f"a UNet with its task's n_classes {MT_CLASSES} and dim "
        f"{build['dim']}, model/ copied")


def phase_multitask(dev, tmp, dirs, card):
    """The multi-task path at full width: the project from `mp
    init_project --model MultiTask`, `mp train` in a subprocess, then
    --continue_training (gates in check_multitask_project and
    run_mp_train); in process the parameter count against the layer
    shapes, the step's times, TFLOP/s, peak memory and device-busy share,
    and a float32 multi-task step card vs host; `mp branch` in a
    subprocess (check_branches). The in-process parts launch no shear
    pass (gated). Returns 0, their shear-pass launches."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    root = Path(tmp) / "multitask"
    root.mkdir()
    proj = write_multitask_project(root, dev, dirs)
    wall, epochs = run_mp_train(proj, dev, MT_EPOCHS, MT_IMAGES,
                                MT_VAL_IMAGES)
    text = (proj / "logs" / "train.txt").read_text()
    if text.count("Sampler: pooled path") < 2:
        raise AssertionError("not every task's sampler took the pooled path")
    check_multitask_project(proj, tmp, MT_EPOCHS)
    c_wall, _ = run_mp_script(
        ["train", "--project_dir", str(proj), "--device", str(dev),
         "--continue_training", "--no_images", "--epochs",
         str(MT_EPOCHS + 1), "--train_images_per_epoch",
         str(MT_CONTINUE_IMAGES), "--val_images_per_epoch",
         str(MT_CONTINUE_VAL_IMAGES)], timeout=900)
    build = check_multitask_project(proj, tmp, MT_EPOCHS + 1)
    t_train = time.perf_counter() - t_phase
    shear_pass.launches = 0

    hparams = YAMLHParams(proj / "train_hparams.yaml", no_log=True)
    # One subject per task suffices for the step's batches
    train_seq, _ = prepare_for_multi_task_2d(
        hparams, just_one=True, no_val=True, continue_training=True,
        logger=ScreenLogger(False), base_path=str(proj), device=dev)
    train_seq.batch_size = BATCH
    batches = [train_seq[i] for i in range(3)]
    dims = [int(x.shape[1]) for x in batches[0][0]]
    if dims != build["dim"] or any(x.shape[0] != BATCH
                                   for x in batches[0][0]):
        raise AssertionError(f"multi-task batch shapes "
                             f"{[tuple(x.shape) for x in batches[0][0]]}")
    compare_f32_step(batches[0], dev, multitask=True)

    model, _, step = fresh_step(torch.bfloat16, dev, 5e-5, multitask=True)
    encoder, heads = multitask_param_counts(MT_CLASSES)
    n_params = sum(p.numel() for p in model.parameters())
    n_encoder = sum(p.numel() for p in model.encoder.parameters())
    log(f"MultiTaskUNet2D (cf {CF}, depth {DEPTH}, tasks {MT_CLASSES} "
        f"classes): {n_params:,} parameters, shared encoder {n_encoder:,}; "
        f"from the layer shapes {encoder + sum(heads):,} (encoder "
        f"{encoder:,}, heads {[f'{h:,}' for h in heads]})")
    if n_params != encoder + sum(heads) or n_encoder != encoder:
        raise AssertionError("the model's parameter count differs from its "
                             "layer shapes'")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    med, q1, q3 = step_time_ms(step, batches, warmup=3, timed=12)
    peak = torch.cuda.max_memory_allocated(dev)
    busy, table = profile_steps(step, batches)
    model.eval()
    fwd_flops = unet_flops_per_plane(
        model, dev, [torch.zeros(1, N_CHANNELS, d, d, device=dev)
                     for d in dims])
    del step, model, batches
    torch.cuda.empty_cache()
    if shear_pass.launches != 0:
        raise AssertionError(f"the multi-task path launched "
                             f"{shear_pass.launches} shear passes")
    launches = shear_pass.launches
    tflops = 3 * fwd_flops * BATCH / (med * 1e-3) / 1e12
    steps = MT_IMAGES // BATCH
    steady = epochs[-1][0]
    exposed = max(0.0, steady - steps * med / 1e3)
    log(f"[{card}] multi-task train step (bf16, batch {BATCH} per task, "
        f"dims {dims}, cf {CF}, depth {DEPTH}): median {med:.2f} ms "
        f"(quartiles {q1:.2f} / {q3:.2f}) over 12 steps after 3 warm-up, "
        f"CUDA events around the step alone; peak allocated "
        f"{peak / 2**30:.2f} GiB; {fwd_flops / 1e9:.1f} GFLOP forward per "
        f"plane pair, step at 3x forward = {tflops:.1f} TFLOP/s "
        f"({100 * tflops / 989:.1f}% of 989 dense bf16 TFLOP/s); "
        f"torch.profiler: device busy {busy:.2f} ms per step "
        f"({100 * busy / med:.1f}%), kernels by self device time over 3 "
        f"steps:\n{table}")
    log(f"[{card}] multi-task mp train: {wall:.1f} s wall for {MT_EPOCHS} "
        f"epochs, --continue_training {c_wall:.1f} s for one more of "
        f"{MT_CONTINUE_IMAGES // BATCH} steps; train "
        f"loop per epoch {[round(e[0], 3) for e in epochs]} s, callbacks "
        f"incl. validation {[round(e[1], 3) for e in epochs]} s; steady "
        f"epoch {steady:.3f} s vs {steps} x step median = "
        f"{steps * med / 1e3:.3f} s: {exposed:.3f} s exposed sampling "
        f"({100 * exposed / steady:.1f}% of the epoch); "
        f"{2 * steps * BATCH / steady:.1f} images/s (both tasks' images)")
    check_branches(proj, build)
    log(f"multi-task phase: {time.perf_counter() - t_phase:.1f} s (project "
        f"+ mp train x2 {t_train:.1f} s)")
    return launches


# ------------------------------------------------------------------ workflow
# `mp train_fusion` on the trained train-256 project: 4 images (the val
# subject + 3 random train subjects) in 2 rounds of 2, 2^20 points per
# image (the script's default 2^22 cut, so that the two-process run of
# phase_multi_device, which passes each rank's points through .npz files,
# moves a quarter of the bytes), otherwise at the script's defaults (30
# epochs, batches of 2^17 points, early stopping 3, same+20 planes); the
# fused probabilities of the points path against predict_image's within
# FUSED_TOL
FUSION_ARGS = ["--overwrite", "--images_per_round", "2", "--min_val_images",
               "4", "--max_points_per_image", str(2 ** 20), "--seed", "0"]
FUSED_TOL = 1e-4
# The fit timed alone in-process: one round's worth of points (2 images x
# 2^22), FIT_EPOCHS epochs at the script's defaults, every epoch run
FIT_POINTS, FIT_EPOCHS = 2 ** 23, 3


def check_fusion_outputs(proj):
    """Gates on what `mp train_fusion` wrote: the fusion file holds
    exactly fusion/W (views, classes) and fusion/b (1, classes), finite,
    meta round 2 and n_views 6; its log has a finite loss and val_dice on
    every epoch line and a best-val_dice line per round. Returns (the
    fusion file, its params, the log's numbers)."""
    files = sorted((proj / "model" / "fusion_weights").glob("*.npz"))
    if len(files) != 1:
        raise AssertionError(f"fusion files {files}")
    with np.load(files[0]) as data:
        keys = sorted(data.files)
    params, _, meta = checkpoint.load_weights(files[0])
    W, b = params["fusion"]["W"], params["fusion"]["b"]
    if (keys != ["__meta__", "params/fusion/W", "params/fusion/b"]
            or W.shape != (N_VIEWS, N_CLASSES) or b.shape != (1, N_CLASSES)
            or not (np.isfinite(W).all() and np.isfinite(b).all())
            or meta != {"round": 2, "n_views": N_VIEWS}):
        raise AssertionError(f"{files[0].name}: keys {keys}, W {W.shape}, "
                             f"b {b.shape}, meta {meta}")
    lines = (proj / "logs" / "train_fusion.txt").read_text().splitlines()
    epochs = [line for line in lines if line.lstrip().startswith("epoch ")]
    for line in epochs:
        loss = float(line.split("loss=")[1].split()[0])
        dice = float(line.split("val_dice=")[1])
        if not (np.isfinite(loss) and np.isfinite(dice)):
            raise AssertionError(f"train_fusion log: {line.strip()}")
    best = [float(line.split(":")[-1]) for line in lines
            if "best fusion val_dice" in line]
    if not epochs or len(best) != 2 or not np.isfinite(best).all():
        raise AssertionError(f"train_fusion log: {len(epochs)} epoch lines, "
                             f"best lines {best}")
    numbers = {
        "points": [int(line.split()[3]) for line in lines
                   if line.startswith("Training fusion on ")],
        "fits": [line.strip() for line in lines
                 if line.lstrip().startswith("fit:")],
        "best": best,
        "peak": [line for line in lines if "Peak allocated" in line],
    }
    return files[0], params, numbers


def time_fusion_fit(points, targets):
    """`_fit_fusion` of `mp train_fusion` on the first FIT_POINTS points
    for FIT_EPOCHS epochs (after one warm-up fit): (seconds per epoch on a
    synchronised host clock, device-busy ms per epoch under
    torch.profiler, its kernel table)."""
    n = min(FIT_POINTS, points.shape[0])
    args = argparse.Namespace(batch_size=2 ** 17, epochs=FIT_EPOCHS,
                              early_stopping=FIT_EPOCHS, learning_rate=1e-3,
                              dice_weight="Simple")

    def fit():
        np.random.seed(0)
        port_train_fusion._fit_fusion(points[:n], targets[:n], N_VIEWS,
                                      N_CLASSES, args, lambda *a: None)

    fit()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit()
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / FIT_EPOCHS
    busy, table = profile_steps(fit, [()], n=1)
    return secs, busy / FIT_EPOCHS, table


def phase_workflow(dev, proj, dirs, card):
    """The project workflow after `mp train`: `mp train_fusion` in a
    subprocess (gates in check_fusion_outputs), the fused probabilities of
    the points path (predict_views_points) against those of predict_image
    with the learned weights on val_0 (gather resampler, within
    FUSED_TOL), `mp predict` with the learned fusion (its log names the
    fusion file, its shear-pass launches equal the plans', it writes
    csv/results.csv) and `mp summary` over its output (through its entry
    point: a host-only tool; its overall fused mean dice equal to the mean
    of results.csv's MJ column to its 3 decimals). Returns (the shear-pass
    launches of the mp predict run, the learned fusion W and b: the
    reference of phase_multi_device's two-process run)."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    fusion_wall, _ = run_mp_script(
        ["train_fusion", "--project_dir", str(proj), "--device", str(dev),
         *FUSION_ARGS], timeout=600)
    fusion_file, fusion, numbers = check_fusion_outputs(proj)
    LOGGED_DRAWS["mp train_fusion"] = logged_draws(
        (proj / "logs" / "train_fusion.txt").read_text())
    n_epochs = [int(f.split()[1]) for f in numbers["fits"]]
    log(f"[{card}] mp train_fusion: {fusion_wall:.1f} s wall, 2 rounds of 2 "
        f"images; points per round {numbers['points']} ("
        f"{[round(n * (N_VIEWS * N_CLASSES + 1) * 4 / 2**30, 3) for n in numbers['points']]}"
        f" GiB of float32 points + int32 targets); epochs run {n_epochs}; "
        f"{numbers['fits']}; best val_dice {numbers['best']}; "
        f"{numbers['peak']}")
    log(f"learned fusion W (views x classes):\n"
        f"{np.array2string(fusion['fusion']['W'], precision=4)}\n"
        f"b: {np.array2string(fusion['fusion']['b'], precision=4)}")

    # The points path against predict_image on val_0, in-process
    hparams = YAMLHParams(proj / "train_hparams.yaml", no_log=True)
    span = float(hparams["fit"]["real_space_span"])
    views = np.load(proj / "views.npz")["arr_0"]
    model = load_unet_weights(
        build_model(hparams["build"],
                    mixed_precision=bool(hparams["fit"]["mixed_precision"]),
                    logger=ScreenLogger(False)),
        get_best_model(proj / "model")).to(dev)
    predictor = MultiViewPredictor(model, sample_dim=DIM,
                                   real_space_span=span, n_classes=N_CLASSES,
                                   device=dev, resampler="gather")
    pair = ImagePair(dirs["val"] / "images" / "val_0.nii.gz",
                     dirs["val"] / "labels" / "val_0.nii.gz")
    pair.set_bg_value(hparams.get_from_anywhere("bg_value"))
    pair.set_scaler(hparams.get_from_anywhere("scaler"))
    pair.load()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    points, targets = predictor.predict_views_points(pair, views)
    torch.cuda.synchronize()
    map_s = time.perf_counter() - t0
    peak_map = torch.cuda.max_memory_allocated(dev)
    W = torch.from_numpy(fusion["fusion"]["W"]).to(dev)
    b = torch.from_numpy(fusion["fusion"]["b"]).to(dev)
    fused_points = torch.softmax((W * points).sum(dim=1) + b[0], dim=-1)
    fit_s, fit_busy, fit_table = time_fusion_fit(points, targets)
    log(f"[{card}] fusion fit alone ({min(FIT_POINTS, points.shape[0])} "
        f"points, {FIT_EPOCHS} epochs of 2^17-point batches, in-process): "
        f"{fit_s:.4f} s per epoch (synchronised host clock); device busy "
        f"{fit_busy:.2f} ms per epoch ({100 * fit_busy / (fit_s * 1e3):.1f}%)"
        f" under torch.profiler; kernels by self device time:\n{fit_table}")
    del points
    probs, _ = predictor.predict_image(pair, views, fusion_params=fusion,
                                       return_per_view=False,
                                       return_probs=True)
    probs = torch.from_numpy(probs).to(dev).reshape(-1, N_CLASSES)
    diff = float((probs - fused_points).abs().max())
    lab_ok = bool((targets.cpu().numpy() == pair.labels.reshape(-1)).all())
    log(f"[{card}] points path on val_0 ({DIM}^3, {N_VIEWS} views, gather): "
        f"mapping {map_s:.3f} s per image (host clock, synchronised), "
        f"{fused_points.shape[0]} points, peak allocated "
        f"{peak_map / 2**30:.2f} GiB; softmax(sum_v W[v] points[:, v] + b) "
        f"vs predict_image's fused probabilities: max abs diff {diff:.3g} "
        f"(<= {FUSED_TOL:g}); targets equal the labels: {lab_ok}")
    if not diff <= FUSED_TOL or not lab_ok:
        raise AssertionError("the points path disagrees with predict_image")
    pair.unload()
    del predictor, model, probs, fused_points, targets
    torch.cuda.empty_cache()

    # mp predict with the learned fusion, evaluated
    val_vol = nifti.load(dirs["val"] / "images" / "val_0.nii.gz").get_fdata()
    planner = MultiViewPredictor(None, sample_dim=DIM, real_space_span=span,
                                 n_classes=N_CLASSES, device=dev)
    plans = view_plans(planner, Image(val_vol[..., None], np.eye(4)), views)
    t0 = time.perf_counter()
    _, launches = run_mp_predict_counted(proj, "pred_fused", [], plans,
                                         require_shear=False)
    predict_wall = time.perf_counter() - t0
    out = proj / "pred_fused"
    pred = nifti.load(out / "nii_files" / "val_0" /
                      "PRED.nii.gz").get_raw_data()
    if pred.shape != (DIM,) * 3 or pred.max() >= N_CLASSES:
        raise AssertionError(f"trained PRED {pred.shape} {pred.dtype}")
    if f"Loaded fusion weights from {fusion_file}" not in (
            out / "predict_log.txt").read_text():
        raise AssertionError("mp predict did not load the fusion weights")
    results = ResultTable.read_csv(out / "csv" / "results.csv")
    mj = results.values[:, results.columns.index("MJ")]
    log(f"[{card}] mp predict with learned fusion (span {span}): PRED "
        f"{pred.shape} {pred.dtype}, classes "
        f"{np.bincount(pred.ravel(), minlength=N_CLASSES).tolist()}, fused "
        f"dice {mj.tolist()}, shear-pass launches {launches}, "
        f"{predict_wall:.1f} s")

    # mp summary over the predictions
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        port_mp.entry_func(["summary", "--dir", str(out)])
    summary_wall, report = time.perf_counter() - t0, printed.getvalue()
    overall = next(line for line in report.splitlines()
                   if line.startswith("Overall fused mean dice:"))
    want = f"{np.nanmean(mj):.3f}"
    if overall.split(":")[1].split()[0] != want:
        raise AssertionError(f"mp summary '{overall}' vs the MJ column's "
                             f"mean {want}")
    log(f"mp summary ({summary_wall:.1f} s, in process): '{overall}' (MJ "
        f"mean {want})")
    log(f"workflow phase: {time.perf_counter() - t_phase:.1f} s")
    return launches, fusion["fusion"]


# ------------------------------------------------------------ multi-device
# Two ranks sharing cuda:0 on gloo (NCCL refuses two ranks on one card),
# started from the library layer: the full-width bf16 model, global batch
# 16 (8 per rank), DP_STEPS steps; then a float32 step at global batch
# DP_F32_BATCH against the one-process step on the same batch
DP_WORKER_FLAG = "--data-parallel-worker"
DP_GLOBAL_BATCH, DP_STEPS, DP_F32_BATCH, DP_LR = 16, 3, 4, 5e-5
# `mp train` as a 1-rank NCCL group: 2 epochs of 10 steps of 16
NCCL_EPOCHS, NCCL_IMAGES, NCCL_VAL_IMAGES = 2, 160, 32
SHARDED_AGREEMENT = 0.9999


def _free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def launch_ranks(cmd, n, timeout, env=None):
    """`cmd` as n ranks under the MPUNET_* launch markers (all on cuda:0
    unless cmd says otherwise), from the repository root; returns (wall
    seconds, each rank's stdout). Fails, ending the others, when a rank
    fails or the time runs out."""
    base = {**os.environ, **(env or {}),
            "MPUNET_COORDINATOR_ADDRESS": f"localhost:{_free_port()}",
            "MPUNET_NUM_PROCESSES": str(n)}
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        cmd, cwd=Path(__file__).resolve().parent, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env={**base, "MPUNET_PROCESS_ID": str(r)}) for r in range(n)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(
                timeout=max(1.0, timeout - (time.perf_counter() - t0))))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    for r, (proc, (out, err)) in enumerate(zip(procs, outs)):
        if proc.returncode != 0:
            log(out[-3000:])
            log(err[-3000:])
            raise AssertionError(f"rank {r} of {cmd[1:4]} exited "
                                 f"{proc.returncode}")
    return wall, [out for out, _ in outs]


def dp_batch(n, seed):
    """A seeded global batch of n full-width slices and random labels."""
    rng = np.random.RandomState(seed)
    return (rng.rand(n, DIM, DIM, N_CHANNELS).astype(np.float32),
            rng.randint(0, N_CLASSES, (n, DIM, DIM, 1)).astype(np.int32))


def dp_trainer(dtype, dev):
    """A Trainer of the glorot-initialised (seed 0) full-width UNet in
    `dtype`, compiled with Adam at DP_LR; data-parallel when a process
    group is active."""
    model = copy.deepcopy(glorot_model(dtype))
    trainer = Trainer(model, logger=ScreenLogger(False), device=dev)
    return trainer.compile_model("Adam", {"lr": DP_LR, "epsilon": 1e-8},
                                 "SparseCategoricalCrossentropy", [])


def f32_step_state(trainer, x, y):
    """One float32 step of `trainer` on (x, y): (loss, the flat parameter
    update, the BN running statistics)."""
    params = list(trainer.model.parameters())
    before = torch.cat([p.detach().flatten() for p in params]).cpu()
    loss = float(trainer.train_step(
        torch.from_numpy(x).to(trainer.device),
        torch.from_numpy(y).to(trainer.device), np.ones(len(x)))["loss"])
    update = torch.cat([p.detach().flatten() for p in params]).cpu() - before
    stats = {k: v.cpu() for k, v in trainer.model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return loss, update, stats


def dp_worker(out):
    """One rank of phase_multi_device's library-layer run (this script
    started with DP_WORKER_FLAG under the MPUNET_* markers): a gloo group
    on cuda:0; DP_STEPS bf16 steps on this rank's half of the global
    batch, each timed between synchronisations; the gradient-sized
    all-reduce alone; one float32 step on its half of the f32 batch.
    Writes rank<r>.json (and rank 0 the f32 step's state) to `out`."""
    import torch.distributed as dist

    from multiplanarunet_tpu_torch.parallel.distributed import (
        maybe_initialize_distributed,
        shutdown_distributed,
    )

    dev = require_cuda(0)
    n, rank = maybe_initialize_distributed(device=dev, backend="gloo")
    res = {"rank": rank, "world": n, "backend": dist.get_backend()}
    trainer = dp_trainer(torch.bfloat16, dev)
    x, y = dp_batch(DP_GLOBAL_BATCH, 1)
    rows = slice(rank * DP_GLOBAL_BATCH // n, (rank + 1) * DP_GLOBAL_BATCH // n)
    X, Y = (torch.from_numpy(a[rows]).to(dev) for a in (x, y))
    losses, step_ms = [], []
    for _ in range(DP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(trainer.train_step(X, Y, np.ones(len(X)))["loss"]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    params = list(trainer.model.parameters())
    res.update(losses=losses, step_ms=step_ms,
               checksum=float(sum(p.double().abs().sum() for p in params)))
    flat = torch.zeros(sum(p.numel() for p in params), device=dev)
    ar_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(flat)
        torch.cuda.synchronize()
        ar_ms.append((time.perf_counter() - t0) * 1e3)
    res.update(allreduce_ms=ar_ms, allreduce_bytes=flat.numel() * 4)
    del trainer, X, Y, flat, params
    torch.cuda.empty_cache()
    x, y = dp_batch(DP_F32_BATCH, 2)
    rows = slice(rank * DP_F32_BATCH // n, (rank + 1) * DP_F32_BATCH // n)
    loss, update, stats = f32_step_state(dp_trainer(torch.float32, dev),
                                         x[rows], y[rows])
    res["loss32"] = loss
    if rank == 0:
        torch.save({"update": update, "stats": stats}, out / "f32_step.pt")
    (out / f"rank{rank}.json").write_text(json.dumps(res))
    shutdown_distributed()


def md_library_layer(dev, tmp, card):
    """a. Two ranks sharing cuda:0 on gloo, from the library layer (gates:
    the loss stream and a parameter checksum bit-equal across the ranks;
    the float32 two-rank step, TF32 off, against the one-process float32
    step on the same global batch: loss within 1e-4 relative, BN running
    statistics within 1e-5, parameter updates as in compare_f32_step)."""
    out = Path(tmp) / "dp_library"
    out.mkdir()
    x, y = dp_batch(DP_F32_BATCH, 2)
    one = f32_step_state(dp_trainer(torch.float32, dev), x, y)
    torch.cuda.empty_cache()
    wall, _ = launch_ranks([sys.executable, str(Path(__file__).resolve()),
                            DP_WORKER_FLAG, str(out)], 2, timeout=600)
    r0, r1 = (json.loads((out / f"rank{r}.json").read_text())
              for r in range(2))
    if (r0["losses"] != r1["losses"] or r0["checksum"] != r1["checksum"]
            or r0["backend"] != "gloo"):
        raise AssertionError(f"the ranks disagree: {r0} vs {r1}")
    two = torch.load(out / "f32_step.pt")
    l1, u1, s1 = one
    rel = abs(r0["loss32"] - l1) / abs(l1)
    stat_err = max((two["stats"][k] - s1[k]).abs().max().item() for k in s1)
    diff = (two["update"] - u1).abs()
    share = (diff <= PARAM_TOL * DP_LR).float().mean().item()
    log(f"[{card}] data-parallel library layer: 2 ranks sharing cuda:0 on "
        f"gloo (started in {wall:.1f} s wall in all), full width bf16, "
        f"global batch {DP_GLOBAL_BATCH} (8 per rank), {DP_STEPS} steps: "
        f"loss {r0['losses']} on both ranks, parameter checksum "
        f"{r0['checksum']:.6f} on both (bit-equal); step ms (host clock, "
        f"synchronised) rank 0 {[round(v, 1) for v in r0['step_ms']]}, "
        f"rank 1 {[round(v, 1) for v in r1['step_ms']]}; gradient-sized "
        f"all-reduce alone ({r0['allreduce_bytes'] / 2**20:.1f} MiB float32, "
        f"gloo over CUDA tensors: staged through the host, not a figure for "
        f"a link between cards) "
        f"{[round(v, 1) for v in r0['allreduce_ms']]} ms")
    log(f"f32 step, global batch {DP_F32_BATCH}: 2 ranks vs 1 process: loss "
        f"{r0['loss32']:.7f} vs {l1:.7f} (rel {rel:.3g} <= 1e-4); BN running "
        f"stats max abs err {stat_err:.3g} (<= 1e-5); parameter updates "
        f"within {PARAM_TOL} lr: {100 * share:.4f}% (>= "
        f"{100 * PARAM_SHARE}%), max diff {diff.max().item() / DP_LR:.4g} lr "
        f"(<= 2)")
    if not (rel <= 1e-4 and stat_err <= 1e-5 and share >= PARAM_SHARE
            and diff.max().item() <= 2 * DP_LR * (1 + 1e-3)):
        raise AssertionError("the two-rank f32 step disagrees with the "
                             "one-process step")


def md_nccl_train(dev, tmp, card, proj, epochs_256):
    """b. `mp train` as a 1-rank NCCL group (the MPUNET_* markers with one
    process) on a copy of the trained project: NCCL start-up, DDP and the
    global-BatchNorm all-reduces on the card. Gates: the log names DDP
    over the nccl group; every artefact written once (check_trained_
    project's gates, one best checkpoint, no rank-suffixed log)."""
    copy_dir = Path(tmp) / "nccl_project"
    shutil.copytree(proj, copy_dir)
    wall, _ = run_mp_script(
        ["train", "--project_dir", str(copy_dir), "--device", "cuda",
         "--overwrite", "--no_images", "--epochs", str(NCCL_EPOCHS),
         "--train_images_per_epoch", str(NCCL_IMAGES),
         "--val_images_per_epoch", str(NCCL_VAL_IMAGES)], timeout=900,
        env={"MPUNET_COORDINATOR_ADDRESS": f"localhost:{_free_port()}",
             "MPUNET_NUM_PROCESSES": "1", "MPUNET_PROCESS_ID": "0"})
    check_trained_project(copy_dir, tmp, n_epochs=NCCL_EPOCHS)
    text = (copy_dir / "logs" / "train.txt").read_text()
    if "DistributedDataParallel over 1 process(es), nccl group" not in text:
        raise AssertionError("mp train under a 1-process launch did not "
                             "train through DDP on an nccl group")
    extra = sorted(p.name for p in (copy_dir / "logs").glob("train_rank*"))
    if extra or len(list((copy_dir / "model").glob("@epoch_*.npz"))) != 1:
        raise AssertionError(f"artefacts written more than once: {extra}")
    loops = [float(line.split()[line.split().index("loop") + 1])
             for line in text.splitlines() if " wall: train loop " in line]
    steps = NCCL_IMAGES // BATCH
    dp_step = loops[-1] / steps * 1e3
    plain_step = float(np.mean([e[0] for e in epochs_256[1:]])) / (
        TRAIN_IMAGES // BATCH) * 1e3
    log(f"[{card}] mp train as a 1-rank nccl group ({NCCL_EPOCHS} epochs of "
        f"{steps} steps of {BATCH}, {wall:.1f} s wall): train loop per step "
        f"{dp_step:.1f} ms in epoch {NCCL_EPOCHS} vs {plain_step:.1f} ms in "
        f"the non-distributed mp train of the training phase (steady "
        f"epochs): {dp_step - plain_step:+.1f} ms per step for DDP and the "
        f"global-BatchNorm all-reduces at world size 1 (host clock, epoch "
        f"walls over different runs)")


def shear_launches_in_logs(out):
    """{image id: shear-pass launches} from every rank's predict log."""
    found = {}
    for path in sorted(out.glob("predict_log*.txt")):
        for line in path.read_text().splitlines():
            if line.startswith("Shear-pass launches for "):
                image_id, n = line[len("Shear-pass launches for "):].split(":")
                if image_id in found:
                    raise AssertionError(f"{image_id} predicted twice")
                found[image_id] = int(n)
    return found


def md_two_process_predict(card, predict_proj, plans):
    """c. `mp predict` as two processes on cuda:0 over the two-image 256^3
    project. Gates: results.csv within 1e-6 of the one-process run's
    (pred_eval of phase_mp_predict); each image's PRED.nii.gz once; no
    .rank folder left; each image's shear-pass launches, read from the
    ranks' logs, those of its plans. Returns the launches."""
    wall, _ = launch_ranks(
        [sys.executable, "-m", "multiplanarunet_tpu_torch.bin.mp", "predict",
         "--project_dir", str(predict_proj), "--out_dir", "pred_2proc",
         "--device", "cuda:0", "--overwrite"], 2, timeout=600)
    out = predict_proj / "pred_2proc"
    one = ResultTable.read_csv(predict_proj / "pred_eval" / "csv" /
                               "results.csv")
    two = ResultTable.read_csv(out / "csv" / "results.csv")
    err = float(np.abs(two.values - one.values).max())
    if (two.index != one.index or two.columns != one.columns
            or not np.isfinite(two.values).all() or err > 1e-6):
        raise AssertionError(f"2-process results.csv differs by {err}")
    preds = sorted(p.parent.name for p in
                   (out / "nii_files").glob("*/PRED.nii.gz"))
    if preds != sorted(one.index) or list(out.glob(".rank*")):
        raise AssertionError(f"PRED files {preds}, rank folders "
                             f"{list(out.glob('.rank*'))}")
    launches = shear_launches_in_logs(out)
    expected = expected_launches(plans, ["shear"] * N_VIEWS)
    if sorted(launches) != preds or set(launches.values()) != {expected}:
        raise AssertionError(f"shear-pass launches {launches} (expected "
                             f"{expected} per image)")
    log(f"[{card}] mp predict as 2 processes on cuda:0 (gloo host group): "
        f"{wall:.1f} s wall for {len(preds)} 256^3 images; results.csv max "
        f"abs diff to 1 process {err:.3g} (<= 1e-6); shear-pass launches "
        f"per image from the rank logs {launches}")
    return sum(launches.values())


def md_sharded(dev, card, predict_proj, views, fusion, plans):
    """d. predict_image_sharded over [cuda:0, cuda:0] against predict_image
    on subject_1 (256^3, learned fusion). Gates: the class maps agree in
    at least SHARDED_AGREEMENT of the voxels; the sharded call's
    shear-pass launches those of its plans. Returns the launches."""
    hparams = YAMLHParams(predict_proj / "train_hparams.yaml", no_log=True)
    model = load_unet_weights(
        build_model(hparams["build"], mixed_precision=True,
                    logger=ScreenLogger(False)),
        get_best_model(predict_proj / "model")).to(dev)
    predictor = MultiViewPredictor(
        model, sample_dim=DIM, real_space_span=hparams["fit"]["real_space_span"],
        n_classes=N_CLASSES, device=dev)
    data = Path(hparams["test_data"]["base_dir"])
    pair = ImagePair(data / "images" / "subject_1.nii.gz")
    pair.set_bg_value(hparams.get_from_anywhere("bg_value"))
    pair.set_scaler(hparams.get_from_anywhere("scaler"))
    pair.load()
    want, _ = predictor.predict_image(pair, views, fusion_params=fusion,
                                      return_per_view=False)
    times = {}
    for name in ("predict_image", "sharded"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        shear_pass.launches = 0
        if name == "sharded":
            got = predictor.predict_image_sharded(pair, views, [dev, dev],
                                                  fusion_params=fusion)
        else:
            predictor.predict_image(pair, views, fusion_params=fusion,
                                    return_per_view=False)
        launches = shear_pass.launches
        times[name] = time.perf_counter() - t0
    modes = list(predictor.remap_modes)
    expected = expected_launches(plans, modes)
    agree = float((got == want).mean())
    log(f"[{card}] predict_image_sharded over [cuda:0, cuda:0], 256^3, "
        f"{N_VIEWS} views, learned fusion: class map agrees with "
        f"predict_image in {agree:.7f} of voxels (>= {SHARDED_AGREEMENT}); "
        f"remap modes {modes}; shear-pass launches {launches} (expected "
        f"{expected}); {times['sharded']:.3f} s vs predict_image "
        f"{times['predict_image']:.3f} s (host clock, one card: no overlap "
        f"to gain)")
    if agree < SHARDED_AGREEMENT or launches != expected or not launches:
        raise AssertionError("predict_image_sharded disagrees")
    pair.unload()
    return launches


def md_two_process_fusion(card, tmp, proj, one):
    """e. `mp train_fusion` as 2 processes on cuda:0 with the workflow
    phase's inputs: a copy of the trained project without the workflow's
    outputs, whose val set is the workflow's fusion set (val_0 and the
    training images its main process drew at random, linked in the order
    its log mapped them, so no image is drawn), with FUSION_ARGS: the
    same images in the same rounds of 2. The workflow's 1-process fit
    `one` ({"W", "b"}) is the reference. Gates: one fusion checkpoint, W
    and b within 1e-6 of the 1-process fit; .points_tmp removed; rank 1's
    log written."""
    mapped = [line.split("Mapping views over ")[1].rstrip(".")
              for line in (proj / "logs" / "train_fusion.txt").read_text()
              .splitlines() if "Mapping views over " in line]
    copy_dir = Path(tmp) / "fusion_project"
    shutil.copytree(proj, copy_dir, ignore=shutil.ignore_patterns(
        "pred*", "fusion_weights", "logs"))
    hp = copy_dir / "train_hparams.yaml"
    hparams = YAMLHParams(hp, no_log=True)
    val_dir = hparams["val_data"]["base_dir"]
    sources = [Path(hparams[f"{split}_data"]["base_dir"])
               for split in ("val", "train")]
    fusion_set = copy_dir / "fusion_set"
    for k, ident in enumerate(mapped):
        name = f"{ident}.nii.gz"
        src = next(d for d in sources if (d / "images" / name).is_file())
        for sub in ("images", "labels"):
            (fusion_set / sub).mkdir(parents=True, exist_ok=True)
            (fusion_set / sub / f"{k:02d}_{name}").symlink_to(src / sub / name)
    hp.write_text(hp.read_text().replace(f"base_dir: {val_dir}",
                                         f"base_dir: {fusion_set}"))
    fusion_dir = copy_dir / "model" / "fusion_weights"
    args = ["--project_dir", str(copy_dir), *FUSION_ARGS]
    two_wall, _ = launch_ranks(
        [sys.executable, "-m", "multiplanarunet_tpu_torch.bin.mp",
         "train_fusion", *args, "--device", "cuda:0"], 2, timeout=600)
    files = list(fusion_dir.glob("*_fusion_weights.npz"))
    if len(files) != 1 or (fusion_dir / ".points_tmp").exists():
        raise AssertionError(f"fusion files {files}, .points_tmp left: "
                             f"{(fusion_dir / '.points_tmp').exists()}")
    two = checkpoint.load_weights(files[0])[0]["fusion"]
    err = max(float(np.abs(two[k] - one[k]).max()) for k in ("W", "b"))
    if err > 1e-6 or not (copy_dir / "logs" /
                          "train_fusion_rank1.txt").exists():
        raise AssertionError(f"2-process fusion fit differs by {err}")
    log(f"[{card}] mp train_fusion as 2 processes on cuda:0 (the workflow "
        f"phase's images {mapped}, rounds of 2): {two_wall:.1f} s wall; "
        f"fusion W, b max abs diff to the workflow's 1-process fit {err:.3g}"
        f" (<= 1e-6); one checkpoint, .points_tmp removed")


def md_too_few_cards(proj):
    """f. `mp train --num_devices 2` on this one-card machine raises the
    named error before it starts any process."""
    from multiplanarunet_tpu_torch._device import TooFewDevicesError

    started = []
    original = subprocess.Popen

    def counted(*args, **kwargs):
        started.append(args)
        return original(*args, **kwargs)

    subprocess.Popen = counted
    visible = torch.cuda.device_count()
    try:
        port_mp.entry_func(["train", "--project_dir", str(proj),
                            "--num_devices", str(visible + 1)])
    except TooFewDevicesError as e:
        message = str(e)
    else:
        raise AssertionError("mp train --num_devices past the visible cards "
                             "did not raise")
    finally:
        subprocess.Popen = original
    want = f"{visible + 1} devices asked, {visible} visible"
    if message != want or started:
        raise AssertionError(f"'{message}' (want '{want}'), processes "
                             f"started: {len(started)}")
    log(f"mp train --num_devices {visible + 1}: TooFewDevicesError "
        f"'{message}' before any process started")


def md_device_defaults(dev):
    """g. The library entry points that place data or start a process
    group, called with no device: shard_batch's tensors and plane_points'
    points land on the card, and initialize_distributed (1 process) and
    maybe_initialize_distributed (under the MPUNET_* markers) start an
    NCCL group on this rank's card (one all_reduce through it), each
    group then destroyed."""
    from datetime import timedelta

    import torch.distributed as dist

    from multiplanarunet_tpu_torch.ops.interp import plane_points
    from multiplanarunet_tpu_torch.parallel import distributed as tdist
    from multiplanarunet_tpu_torch.parallel.mesh import shard_batch

    got = {}
    x, y = shard_batch((np.ones((2, 3), np.float32), torch.zeros(2)))
    got["shard_batch"] = f"{x.device}, {y.device}"
    got["plane_points"] = str(plane_points(
        geometry.plane_basis(np.array([0.3, -0.5, 0.8])), 1.5, 31.0,
        8).device)

    def group(start):
        start()
        try:
            one = torch.ones(1, device=dev)
            dist.all_reduce(one)
            return (f"{dist.get_backend()} on cuda:"
                    f"{torch.cuda.current_device()}, all_reduce "
                    f"{float(one):g}")
        finally:
            tdist.shutdown_distributed()

    got["initialize_distributed"] = group(
        lambda: tdist.initialize_distributed(
            f"localhost:{_free_port()}", 1, 0,
            timeout=timedelta(seconds=120)))
    markers = {"MPUNET_COORDINATOR_ADDRESS": f"localhost:{_free_port()}",
               "MPUNET_NUM_PROCESSES": "1", "MPUNET_PROCESS_ID": "0"}
    with mock.patch.dict(os.environ, markers):
        got["maybe_initialize_distributed"] = group(
            tdist.maybe_initialize_distributed)
    want = {"shard_batch": "cuda:0, cuda:0", "plane_points": "cuda:0",
            "initialize_distributed": "nccl on cuda:0, all_reduce 1",
            "maybe_initialize_distributed": "nccl on cuda:0, all_reduce 1"}
    log(f"device defaults with no device given: {got}")
    if got != want:
        raise AssertionError(f"device defaults {got}, want {want}")


def phase_multi_device(dev, tmp, card, proj, epochs_256, predict_proj, views,
                       fusion, plans, fusion_ref):
    """Multi-device and multi-process execution on this one card: a. the
    library layer as two ranks on gloo; b. `mp train` as a 1-rank NCCL
    group; c. `mp predict` as two processes; d. predict_image_sharded over
    [cuda:0, cuda:0]; e. `mp train_fusion` as two processes against the
    workflow's one-process fit `fusion_ref`; f. the named error for more
    cards than visible; g. the device defaults of the library entry
    points. Returns the shear-pass launches of its paths (the mapping of
    mp train_fusion takes the gather path and launches none)."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    md_library_layer(dev, tmp, card)
    md_nccl_train(dev, tmp, card, proj, epochs_256)
    paths = {"mp predict (2 processes)": md_two_process_predict(
        card, predict_proj, plans)}
    paths["predict_image_sharded"] = md_sharded(dev, card, predict_proj,
                                                views, fusion, plans)
    md_two_process_fusion(card, tmp, proj, fusion_ref)
    md_too_few_cards(proj)
    md_device_defaults(dev)
    log(f"multi-device phase: {time.perf_counter() - t_phase:.1f} s")
    return paths


# ------------------------------------------------------- config surface
# The configuration surface the JAX package takes by name: its activation
# names on one decoder activation of predict-256's U-Net (a 46-plane chunk,
# 96 channels: the first level's 90 filters lane-padded to 8, 256^2), each
# in float32 against the plain float32 version on the host within
# CS_ACT_TOL (relative past 1: |card - host| <= CS_ACT_TOL * max(1,
# |host|); the same NaN and infinities); `mp predict` of one structured
# 128^3 subject through a PowerTransformer + mish project; the new
# scalers' host seconds; and the optimizer options, each update on the
# card against the host's from the same state and gradients.
CS_ACTIVATIONS = (
    "celu", "hard_sigmoid", "hard_silu", "hard_swish", "hard_tanh",
    "identity", "log1mexp", "log_sigmoid", "log_softmax", "mish",
    "normalize", "relu6", "soft_sign", "softmax", "sparse_plus",
    "sparse_sigmoid", "squareplus", "standardize")
CS_ACT_SHAPE, CS_ACT_TOL, CS_ACT_REPS = (46, 96, DIM, DIM), 1e-6, 5
# The host comparison takes the first CS_ACT_CHECK_PLANES planes of that
# tensor (25 M values, an eleventh of the host's work; the timing takes
# all 46)
CS_ACT_CHECK_PLANES = 4
# (b)'s subject: the PowerTransformer's yeo-johnson fit (scipy's Brent
# search) grows with the voxels, about 49 s at 256^3 on the host; at 128^3
# it is an eighth of that, and the views and passes, so the launches, stay
CS_SUBJECT = 128
CS_OPTIMIZERS = (("Adam", {}),
                 ("RMSprop", {"centered": True}),
                 ("Adam", {"mu_dtype": "bfloat16"}),
                 ("Lion", {"mu_dtype": "bfloat16"}),
                 ("SGD", {"momentum": 0.9, "accumulator_dtype": "bfloat16"}))
CS_LR, CS_STATE_TOL, CS_STEPS = 5e-5, 1e-6, 6
CS_PROJECT_EDITS = (('scaler: "RobustScaler"', 'scaler: "PowerTransformer"'),
                    (f"  depth: {DEPTH}\n",
                     f"  depth: {DEPTH}\n  activation: \"mish\"\n"))


def cs_activations(dev, card):
    """(a) Each activation name in float32 on the card against the same
    function on the host, on the first CS_ACT_CHECK_PLANES planes of one
    randn * 3 tensor of CS_ACT_SHAPE, the difference taken on the card;
    ms per call (CUDA events) on the whole tensor in float32 and bf16
    beside relu's."""
    from multiplanarunet_tpu_torch.models.unet import get_activation

    gen = torch.Generator(device=dev).manual_seed(13)
    x = torch.randn(CS_ACT_SHAPE, generator=gen, device=dev) * 3.0
    x_bf = x.to(torch.bfloat16)
    x_check = x[:CS_ACT_CHECK_PLANES]
    x_host = x_check.cpu()
    rows, worst = [], 0.0
    for name in ("relu",) + CS_ACTIVATIONS:
        fn = get_activation(name)
        ms = cuda_ms(lambda: fn(x), CS_ACT_REPS)
        ms_bf = cuda_ms(lambda: fn(x_bf), CS_ACT_REPS)
        if fn(x_bf).dtype != torch.bfloat16:
            raise AssertionError(f"{name} left bf16")
        got = fn(x_check)
        want = fn(x_host).to(dev)
        finite = torch.isfinite(want)
        same_rest = (torch.equal(finite, torch.isfinite(got)) and torch.equal(
            torch.nan_to_num(want[~finite]), torch.nan_to_num(got[~finite])))
        err = float(torch.where(finite, (got - want).abs()
                                / want.abs().clamp_min(1.0), 0.0).max())
        del got, want, finite
        worst = max(worst, err)
        rows.append(f"{name} {ms:.3f} / {ms_bf:.3f} ms, err {err:.3g}")
        if not (err <= CS_ACT_TOL and same_rest):
            raise AssertionError(f"activation {name}: card vs host {err:.3g}"
                                 f" (<= {CS_ACT_TOL:g}), the same non-finite "
                                 f"values: {same_rest}")
    log(f"[{card}] (a) activations on {CS_ACT_SHAPE} (randn * 3), float32 / "
        f"bf16 ms per call (CUDA events, {CS_ACT_REPS} calls), float32 "
        f"error vs the host on its first {CS_ACT_CHECK_PLANES} planes "
        f"(relative past 1, <= {CS_ACT_TOL:g}, non-finite values equal): "
        + "; ".join(rows))
    return worst


def cs_scaler_seconds(vol):
    """(c) Host seconds of fit + transform of the new scalers (beside the
    PowerTransformer timed on the predict subject): box-cox on a 64^3
    subsample of the subject (every size // 64-th voxel per axis), + 1
    (strictly positive; scipy's box-cox likelihood takes over a minute
    for a whole 256^3 subject, linear in the voxels), the
    QuantileTransformer's normal
    output, Normalizer, Binarizer, FunctionTransformer (log1p), and the
    encoders on the subject's label-like rounding (intensity / 20)."""
    from multiplanarunet_tpu_torch.preprocessing.scaling import get_scaler

    coded = np.round(vol / 20.0)
    step = max(1, vol.shape[0] // 64)
    cases = ((f"PowerTransformer box-cox ({vol.shape[0] // step}^3)",
              vol[::step, ::step, ::step] + 1.0, "PowerTransformer",
              {"method": "box-cox"}),
             ("QuantileTransformer normal", vol, "QuantileTransformer",
              {"output_distribution": "normal"}),
             ("Normalizer", vol, "Normalizer", {}),
             ("Binarizer", vol, "Binarizer", {"threshold": 50.0}),
             ("FunctionTransformer log1p", vol, "FunctionTransformer",
              {"func": np.log1p}),
             ("LabelEncoder", coded, "LabelEncoder", {}),
             ("OrdinalEncoder", coded, "OrdinalEncoder", {}))
    secs, out = {}, {}
    for label, data, name, kwargs in cases:
        np.random.seed(0)
        t0 = time.perf_counter()
        scaler = get_scaler(name, **kwargs).fit(data)
        result = scaler.transform(data)
        secs[label] = time.perf_counter() - t0
        if result.shape != data.shape or not np.isfinite(result).all():
            raise AssertionError(f"{label}: {result.shape}, finite "
                                 f"{np.isfinite(result).all()}")
        out[label] = scaler
    lam = float(out[cases[0][0]].channels[0].lambda_)
    return secs, lam


def cs_predict(dev, tmp, views, fusion, card):
    """(b) `mp predict` of one structured CS_SUBJECT^3 subject through a
    project whose YAML says `scaler: PowerTransformer` and `activation:
    mish` (run_mp_predict_counted: the launches of the subject's plans,
    72, gated), the PowerTransformer's fit in its load timed ((c)); then
    in process the model built from that YAML (mish, gated) and
    `predict_image` on that subject's ImagePair, scaled by the port's
    PowerTransformer as mp predict fitted it. Gate: the class maps equal
    in every voxel. Returns (launches, the subject's volume)."""
    from multiplanarunet_tpu_torch.preprocessing import scaling

    root = Path(tmp) / "config_surface"
    root.mkdir()
    proj, data = write_project(root, views, fusion, dev,
                               subjects=("subject_1",),
                               edits=CS_PROJECT_EDITS, size=CS_SUBJECT)
    hparams = YAMLHParams(proj / "train_hparams.yaml", no_log=True)
    model = load_unet_weights(
        build_model(hparams["build"], mixed_precision=True,
                    logger=ScreenLogger(False)),
        get_best_model(proj / "model")).to(dev)
    if model.activation != "mish" or hparams["fit"]["scaler"] != \
            "PowerTransformer":
        raise AssertionError(f"project built {model.activation}, scaler "
                             f"{hparams['fit']['scaler']}")
    predictor = MultiViewPredictor(
        model, sample_dim=DIM, real_space_span=hparams["fit"]["real_space_span"],
        n_classes=N_CLASSES, device=dev)
    subject = nifti.load(data / "images" / "subject_1.nii.gz")
    plans = view_plans(predictor, Image(subject.get_fdata()[..., None],
                                        np.eye(4)), views)
    del subject
    fits, images = [], []
    original_fit = scaling.MultiChannelScaler.fit

    def timed_fit(self, X):
        t0 = time.perf_counter()
        result = original_fit(self, X)
        fits.append(time.perf_counter() - t0)
        return result

    scaling.MultiChannelScaler.fit = timed_fit
    try:
        t0 = time.perf_counter()
        timings, launches = run_mp_predict_counted(proj, "pred_power", [],
                                                   plans, images=images)
        wall = time.perf_counter() - t0
    finally:
        scaling.MultiChannelScaler.fit = original_fit
    if launches != 72:
        raise AssertionError(f"mp predict (PowerTransformer): {launches} "
                             f"shear-pass launches, not 72")
    t = timings["subject_1"]
    (pair,) = images
    scaler = pair.scaler
    if len(fits) != 1 or scaler.scaler_name != "PowerTransformer":
        raise AssertionError(f"mp predict fitted {len(fits)} scalers, "
                             f"{scaler}")
    vol = pair.image
    t0 = time.perf_counter()
    scaler.transform(vol)
    transform_s = time.perf_counter() - t0
    lam = float(scaler.channels[0].lambda_)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cls, _ = predictor.predict_image(pair, views, fusion_params=fusion,
                                     return_per_view=False)
    predict_s = time.perf_counter() - t0
    pred = nifti.load(proj / "pred_power" / "nii_files" / "subject_1" /
                      "PRED.nii.gz").get_raw_data()
    agree = float((pred == cls).mean())
    log(f"[{card}] (b) mp predict, PowerTransformer + mish, one structured "
        f"{CS_SUBJECT}^3 subject: {wall:.1f} s wall; host load (decode + 1pct + "
        f"PowerTransformer fit and transform) {t['load']:.3f} s, "
        f"predict_image {t['predict']:.3f} s, save {t['save']:.3f} s; "
        f"shear-pass launches {launches} (72); in process predict_image "
        f"{predict_s:.3f} s; class map equal to mp predict's in "
        f"{agree:.7f} of voxels (gate: all)")
    import scipy

    log(f"[{card}] (c) PowerTransformer (yeo-johnson) on that subject: fit "
        f"{fits[0]:.3f} s (in mp predict's load), transform {transform_s:.3f}"
        f" s, lambda {lam:.7g} (numpy {np.__version__}, scipy "
        f"{scipy.__version__})")
    if pred.shape != cls.shape or not np.array_equal(pred, cls):
        raise AssertionError("mp predict (PowerTransformer) differs from "
                             "predict_image")
    pair.unload()
    del predictor, model
    torch.cuda.empty_cache()
    return launches, vol


def cs_check_update(name, kwargs, opt, gen, card):
    """One more update of `opt` (on the card, after its timed steps) and
    of a host copy of it (parameters, state and count copied) from the
    same random gradients. Gates: each float32 tensor (the parameters,
    each float32 moment) within CS_STATE_TOL of the host's relative to its
    largest magnitude (a CUDA division by a scalar multiplies by the
    reciprocal, one rounding more than the host's, so a parameter that an
    update brings near 0 can differ by far more than 1e-6 of itself), each
    bf16 moment within one bf16 ulp. Returns the worst relative float32
    difference."""
    host_params = [torch.nn.Parameter(p.detach().cpu())
                   for p in opt.packed.params]
    host = init_optimizer(name, host_params, lr=CS_LR, **kwargs)
    for key, value in opt.state.items():
        host.state[key].copy_(value.cpu())
    host.count = opt.count
    for p, q in zip(opt.packed.params, host_params):
        g = torch.randn(q.shape, generator=gen) * 1e-3
        q.grad = g
        p.grad = g.to(p.device)
    opt.step()
    host.step()
    worst = 0.0
    pairs = [("params", opt.packed.data, host.packed.data)] + [
        (k, v, host.state[k]) for k, v in opt.state.items()]
    for key, card_t, host_t in pairs:
        # the difference taken on the card, in float64
        a, b = card_t.double(), host_t.to(card_t.device).double()
        if card_t.dtype == torch.bfloat16:
            # one bf16 ulp of |b| in [2^(e-1), 2^e): 2^(e-8)
            exp = torch.frexp(b.abs()).exponent
            ulp = torch.ldexp(torch.ones_like(b), exp - 8)
            if not bool(((a - b).abs() <= ulp).all()):
                raise AssertionError(f"{name} {kwargs}: bf16 {key} more "
                                     f"than one ulp from the host's")
            continue
        rel = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
        worst = max(worst, rel)
        if rel > CS_STATE_TOL:
            raise AssertionError(f"{name} {kwargs}: {key} differs from the "
                                 f"host's by {rel:.3g} relative")
    return worst


def cs_optimizers(dev, card):
    """(d) train-256's step (bf16 U-Net cf 2, depth 4, batch 16 of 256^2)
    under each of CS_OPTIMIZERS: its median ms (CUDA events, CS_STEPS
    steps after 2), the optimizer state's bytes, and one update card vs
    host (cs_check_update)."""
    gen = torch.Generator().manual_seed(21)
    batch = (torch.randn(BATCH, DIM, DIM, N_CHANNELS, generator=gen).to(dev),
             torch.randint(0, N_CLASSES, (BATCH, DIM, DIM, 1),
                           generator=gen).to(dev),
             np.ones(BATCH, np.float32))
    base = glorot_model(torch.bfloat16)
    rows = []
    for name, kwargs in CS_OPTIMIZERS:
        model = copy.deepcopy(base).to(dev).train()
        opt = init_optimizer(name, model.parameters(), lr=CS_LR, **kwargs)
        step = TrainStep(model, opt, SparseCategoricalCrossentropy(), {})
        med, q1, q3 = step_time_ms(step, [batch], warmup=2, timed=CS_STEPS)
        state_bytes = sum(t.numel() * t.element_size()
                          for t in opt.state.values())
        dtypes = sorted({str(t.dtype).split(".")[-1]
                         for t in opt.state.values()})
        err = cs_check_update(name, kwargs, opt, gen, card)
        rows.append(f"{name} {kwargs or '(float32 state)'}: step {med:.2f} "
                    f"ms ({q1:.2f} / {q3:.2f}), state {state_bytes / 2**20:.1f}"
                    f" MiB {dtypes}, card vs host {err:.3g}")
        del step, opt, model
        torch.cuda.empty_cache()
    log(f"[{card}] (d) train step (bf16, batch {BATCH}, {DIM}^2, cf {CF}, "
        f"depth {DEPTH}) per optimizer, median (quartiles) over {CS_STEPS} "
        f"steps "
        f"after 2; the update card vs host within {CS_STATE_TOL:g} relative "
        f"(float32) and one ulp (bf16 moments): " + "; ".join(rows))


def phase_config_surface(dev, tmp, views, fusion, card):
    """The configuration surface the JAX package takes by name, at full
    width: (a) cs_activations, (b) cs_predict, (c) cs_scaler_seconds, (d)
    cs_optimizers. Returns (b)'s shear-pass launches (72)."""
    marks = [time.perf_counter()]
    torch.cuda.empty_cache()
    err = cs_activations(dev, card)
    marks.append(time.perf_counter())
    launches, vol = cs_predict(dev, tmp, views, fusion, card)
    marks.append(time.perf_counter())
    secs, lam = cs_scaler_seconds(vol)
    log(f"(c) scalers' host seconds (fit + transform, one "
        f"{vol.shape[0]}^3 subject): "
        + ", ".join(f"{k} {v:.3f} s" for k, v in secs.items())
        + f"; box-cox lambda {lam:.7g}")
    del vol
    marks.append(time.perf_counter())
    cs_optimizers(dev, card)
    marks.append(time.perf_counter())
    parts = ", ".join(f"({k}) {b - a:.1f} s"
                      for k, a, b in zip("abcd", marks, marks[1:]))
    log(f"config surface phase: {marks[-1] - marks[0]:.1f} s ({parts}; "
        f"activations' worst float32 error {err:.3g})")
    return launches


def main():
    t_start = time.perf_counter()
    dev = require_cuda()
    torch.manual_seed(0)
    # Host seconds of each phase, in order, and the threefry launches of
    # this process in each (counted from 0 at its start)
    seconds, draws = {}, {}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        prng.threefry2x32.launches = 0
        result = fn(*args)
        draws[name] = prng.threefry2x32.launches
        seconds[name] = time.perf_counter() - t0
        return result

    # nvcc runs in a thread beside the environment and the main path's
    # set-up, which need no kernel
    pool = concurrent.futures.ThreadPoolExecutor(1)
    build = pool.submit(_build.kernels)
    card = phase("environment", phase_environment)
    # Shear-pass launches of each path, each counted from 0 just before it
    # (the kernel vs plain comparisons are not counted)
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        predictor, images, views, fusion, plans = phase(
            "main-path set-up", setup_main_path, dev, tmp)
        phase("kernel build", phase_kernel_build, build)
        pool.shutdown()
        err = phase("kernel vs plain", phase_kernel_vs_plain, dev, plans)
        threefry = phase("threefry vs plain", phase_threefry, dev, card)
        phase("oracle", phase_oracle, dev)
        paths[f"main {DIM}^3"], main_runs = phase(
            "main path", phase_main_path, dev, predictor, images, views,
            fusion)
        paths["U-Net forms A/B"] = phase(
            "U-Net forms", phase_unet_variants, dev, tmp, predictor,
            images[1], views, fusion, card, main_runs)
        phase("reference swap", phase_reference_swap, predictor, images[0],
              views, fusion)
        times = phase("timing", phase_timing, dev, plans)
        e, paths[f"grouped {DIM}^3"] = phase(
            "grouped remap", phase_grouped_remap, dev, predictor, images[0],
            views, fusion, plans)
        err = max(err, e)
        paths[f"gather {DIM}^3"] = phase("gather", phase_gather, dev,
                                         predictor, images[0], views, fusion)
        paths["per-view API"] = phase("per-view", phase_per_view, dev,
                                      predictor, images[0], views, tmp, card)
        del images
        phase("u8", phase_u8, dev)
        paths["mp predict"], predict_proj = phase(
            "mp predict", phase_mp_predict, dev, predictor, views, fusion,
            plans, tmp)
        e, paths[f"{DIM_LARGE}^3"] = phase(f"{DIM_LARGE}^3", phase_large, dev,
                                           predictor.model, views, fusion)
        err = max(err, e)
        del predictor
        paths["mp predict (PowerTransformer, mish)"] = phase(
            "config surface", phase_config_surface, dev, tmp, views, fusion,
            card)
        proj, dirs, epochs_256 = phase("training", phase_training, dev, tmp,
                                       card)
        paths["mp predict (QuantileTransformer)"] = phase(
            "callbacks and tools", phase_callbacks_tools, dev, tmp, proj,
            dirs, epochs_256, card)
        paths["3D (in-process)"] = phase("3D", phase_3d, dev, tmp,
                                         proj.parent / "data", dirs, card)
        paths["multi-task (in-process)"] = phase(
            "multi-task", phase_multitask, dev, tmp, dirs, card)
        paths["mp predict (learned fusion)"], fusion_ref = phase(
            "workflow", phase_workflow, dev, proj, dirs, card)
        paths.update(phase("multi-device", phase_multi_device, dev, tmp,
                           card, proj, epochs_256, predict_proj, views,
                           fusion, plans, fusion_ref))
    view0 = [times["stack"], times["remap"]]
    log(f"shear-pass launches per path: {paths}")
    # The threefry kernel's comparisons with its plain version do not
    # count; every path that trains draws through it: each `mp train` and
    # `mp train_fusion` (their logs) and the in-process training, 3D and
    # multi-task checks (init, sampler batches)
    del draws["threefry vs plain"]
    drawn = {**{f"{k} (in-process)": v for k, v in draws.items() if v},
             **LOGGED_DRAWS}
    log(f"threefry2x32 launches per path: {drawn}")
    idle = [k for k in ("training", "3D", "multi-task") if not draws[k]]
    idle += [k for k, v in LOGGED_DRAWS.items() if not v]
    if idle or not any(k.startswith("mp train_fusion") for k in drawn):
        raise AssertionError(f"paths that draw launched no threefry "
                             f"kernel: {idle or 'mp train_fusion'}")
    log("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                      for k, v in seconds.items())
        + f"; sum {sum(seconds.values()):.1f} s (wall "
        f"{time.perf_counter() - t_start:.1f} s)")
    log(f"card: {card}")
    log(json.dumps({"kernels": [{
        "name": "shear_pass",
        "route": "cuda",
        "source": "multiplanarunet_tpu_torch/csrc/shear_pass.cu",
        "replaces": "multiplanarunet_tpu/ops/pallas_shear.py:131",
        "launches": sum(paths.values()),
        "max_abs_err": err,
        "ms": sum(t["ms"] for t in view0),
        "plain_ms": sum(t["plain_ms"] for t in view0),
        "bound_ms": sum(t["bound_ms"] for t in view0),
        "bound_by": "bytes",
        "library_ms": sum(t["library_ms"] for t in view0),
    }, {
        "name": "threefry2x32",
        "route": "cuda",
        "source": "multiplanarunet_tpu_torch/csrc/threefry.cu",
        "replaces": "jax.random threefry2x32 under XLA, "
                    "multiplanarunet_tpu/ops/elastic.py:124-126",
        "launches": sum(drawn.values()),
        "max_abs_err": threefry["max_abs_err"],
        "ms": threefry["ms"],
        "plain_ms": threefry["plain_ms"],
        "bound_ms": threefry["bound_ms"],
        "bound_by": "operations",
        "library_ms": None,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == [DP_WORKER_FLAG]:
        dp_worker(Path(sys.argv[2]))
    else:
        main()
