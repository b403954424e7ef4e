#!/usr/bin/env python3
"""Smoke run of the PyTorch port (multiplanarunet_tpu_torch) on one NVIDIA
GPU: builds the CUDA shear-pass kernel from csrc/, holds it against its
plain PyTorch version, checks the predictor's geometry with a one-hot
oracle (shear, gather and auto's fallback), then drives fused multi-view
inference at full width (U-Net complexity_factor 2, depth 4, dim 256, 7
classes; 6 views + learned fusion over 256^3 volumes, bench.py's
configuration) and times it. Then: the channel-grouped remap against the
ungrouped one, the gather resampler on a full-width 256^3 volume, uint8
staging, `mp predict` end to end on a two-image NIfTI project, and one
512^3 volume with the kernel held against its plain version at that
volume's largest shapes. Each path's shear-pass launches are counted from
0 just before it and gated against what its plans and remap modes say.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Any failed check raises and the process exits non-zero. Without a CUDA
device it raises before printing any result. The second-to-last line of
standard output is a JSON object describing the kernels; the last is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch import nn

from multiplanarunet_tpu_torch._device import require_cuda
from multiplanarunet_tpu_torch.bin import mp as port_mp
from multiplanarunet_tpu_torch.evaluate.metrics import dice_from_counts
from multiplanarunet_tpu_torch.image.image_pair import ImagePair
from multiplanarunet_tpu_torch.image.volume_sampler import VolumeSampler
from multiplanarunet_tpu_torch.io import nifti
from multiplanarunet_tpu_torch.logging.log_results import load_result_dicts
from multiplanarunet_tpu_torch.models import checkpoint
from multiplanarunet_tpu_torch.models.unet import UNet
from multiplanarunet_tpu_torch.ops import _build, geometry
from multiplanarunet_tpu_torch.ops.shear import shear_resample
from multiplanarunet_tpu_torch.ops.shear_pass import (
    shear_pass,
    shear_pass_reference,
)
from multiplanarunet_tpu_torch.ops.shear_plan import (
    plan_affine_resample,
    plan_stage_bytes,
)
from multiplanarunet_tpu_torch.utils.fusion.fuse_and_predict import (
    MultiViewPredictor,
    class_map_counts,
)

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
    """Minimal ImagePair stand-in: shape, affine and the port's sampler."""

    def __init__(self, volume, affine):
        self.shape = volume.shape
        self.affine = affine
        self.interpolator = VolumeSampler(volume, affine, bg_value=0.0)


class OneHotOracle(nn.Module):
    """'Model' returning one_hot(round(input intensity)): fed a label
    volume as the image, the pipeline must reconstruct the labels."""

    def __init__(self, n_classes):
        super().__init__()
        self.n_classes = n_classes

    def forward(self, x):
        cls = torch.clamp(torch.round(x[:, 0].float()), 0, self.n_classes - 1)
        onehot = nn.functional.one_hot(cls.long(), self.n_classes)
        return onehot.permute(0, 3, 1, 2).float()


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


def jax_format_unet_weights(path, n_classes, n_channels, depth, cf, seed,
                            init_filters=64):
    """Write a UNet checkpoint in the JAX package's .npz format from numpy
    alone: flax key names, HWIO kernels drawn glorot-uniform from a seed,
    zero biases, BN scale 1 / bias 0 / mean 0 / var 1."""
    rng = np.random.RandomState(seed)
    entries = {}

    def conv(name, k, cin, cout):
        lim = np.sqrt(6.0 / (k * k * cin + k * k * cout))
        entries[f"params/{name}/kernel"] = rng.uniform(
            -lim, lim, (k, k, cin, cout)).astype(np.float32)
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


def unet_flops_per_plane(model, dev):
    """Forward FLOPs of one DIM x DIM plane: 2 * MACs of every convolution,
    counted with forward hooks on one plane."""
    flops = []

    def hook(mod, _, out):
        kh, kw = mod.kernel_size
        flops.append(2 * out.shape[2] * out.shape[3] * mod.out_channels
                     * mod.in_channels * kh * kw)

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, nn.Conv2d)]
    with torch.inference_mode():
        model(torch.zeros(1, N_CHANNELS, DIM, DIM, device=dev))
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


def compare_plan_passes(plan, method, channels, dtype, gen):
    """Feed every pass of `plan` a random input (drawn on the card from
    `gen`) through the kernel, all channels at once, and through the plain
    version one channel at a time (a pass treats each channel alone, and
    one channel of a 512^3 stage keeps the plain version's float32
    temporaries small); returns the max abs difference."""
    err = 0.0
    for i, op in enumerate(plan.ops):
        shape = [ext for (_, ext) in plan.stages[i]] + [channels]
        A = torch.rand(shape, generator=gen, device=gen.device).to(dtype)
        got = shear_pass(A, op, method)
        for c in range(channels):
            want = shear_pass_reference(A[..., c:c + 1].contiguous(), op,
                                        method)
            got_c = got[..., c].float()
            if not torch.isfinite(got_c).all():
                raise AssertionError("kernel output holds non-finite values")
            err = max(err, (got_c - want[..., 0].float()).abs().max().item())
            del want, got_c
        del A, got
    if err > TOL[dtype]:
        raise AssertionError(f"kernel vs plain: max abs err {err} > "
                             f"{TOL[dtype]} ({method}, {dtype})")
    return err


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
    k = _build.kernels()
    log(f"kernel library {k.path.name}: built in {k.build_seconds:.2f} s")
    for line in k.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    return card


def phase_kernel_vs_plain(dev, main_plans):
    rng = np.random.RandomState(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0
    for trial in range(3):
        N = random_affine(rng)
        src, out = (48, 44, 40), (46, 42, 38)
        c = np.asarray(src) / 2.0 - N @ (np.asarray(out) / 2.0)
        plan = plan_affine_resample(N, c, src, out)
        for dtype in (torch.float32, torch.bfloat16):
            for method in ("linear", "cubic"):
                e = compare_plan_passes(plan, method, 3, dtype, gen)
                log(f"random plan {trial} {method:6s} {str(dtype):14s} "
                    f"max abs err {e:.3g} (tol {TOL[dtype]:.3g})")
                worst = max(worst, e)
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
    seconds, per_volume_launches, shares = [], [], []
    for i, img in enumerate(images):
        before = shear_pass.launches
        t0 = time.perf_counter()
        fused, _ = predictor.predict_image(img, views, fusion_params=fusion,
                                           n_planes="same+20",
                                           return_per_view=False)
        seconds.append(time.perf_counter() - t0)  # ends in a host fetch
        per_volume_launches.append(shear_pass.launches - before)
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
    n_valid = len(predictor._plane_offsets(images[0], "same+20"))
    plane_flops = unet_flops_per_plane(predictor.model, dev)
    model_flops = plane_flops * N_VIEWS * n_valid
    tflops = model_flops / (unet * 1e-3) / 1e12
    log(f"main path: {steady:.3f} s/volume after the first "
        f"({60.0 / steady:.2f} volumes/min; first {seconds[0]:.3f} s); "
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
    # their argmax is the class map
    probs, _ = predictor.predict_image(images[0], views, fusion_params=fusion,
                                       return_per_view=False,
                                       return_probs=True)
    cls, _ = predictor.predict_image(images[0], views, fusion_params=fusion,
                                     return_per_view=False)
    agree = float((probs.argmax(-1) == cls).mean())
    sum_err = float(np.abs(probs.sum(-1) - 1.0).max())
    log(f"fused probabilities: finite {bool(np.isfinite(probs).all())}, "
        f"sum max |err| {sum_err:.3g}, argmax vs class map agreement "
        f"{agree:.6f}")
    if not (np.isfinite(probs).all() and sum_err < 1e-4 and agree > 0.999):
        raise AssertionError("fused probabilities are wrong")
    return launches


def phase_timing(dev, plans):
    """One view's stack plan and remap plan (6 passes each) at the main
    path's shapes, kernel vs plain, alternating plain/kernel/kernel/plain;
    and the remap plan at the shapes of a channel group of 2 (C=3)."""
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

        times = {"plain": [], "kernel": []}
        for arm in ("plain", "kernel", "kernel", "plain"):
            fn = shear_pass if arm == "kernel" else shear_pass_reference
            run(fn)  # warm
            times[arm].append(cuda_ms(lambda: run(fn), 5))
        k, p = np.mean(times["kernel"]), np.mean(times["plain"])
        gbs = plan_bytes(plan, ch) / (k * 1e-3) / 1e9
        log(f"{name} plan {tuple(plan.src_shape)} -> "
            f"{tuple(plan.out_shape)} x C={ch} bf16, 6 {method} passes: "
            f"kernel {k:.3f} ms, plain {p:.3f} ms (runs "
            f"{[round(t, 3) for t in times['kernel']]} / "
            f"{[round(t, 3) for t in times['plain']]}); kernel moves at "
            f"least {plan_bytes(plan, ch) / 1e9:.3f} GB: {gbs:.0f} GB/s, "
            f"{100 * gbs / 3350:.1f}% of the H100 SXM's 3.35 TB/s")
        out[name] = (k, p)
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


def structured_subject(dev, seed):
    """A (DIM,)*3 float32 image and uint8 labels shaped like a scan, made
    on the card: zero background around an ellipsoid that holds a smoothed
    random field (intensity 100 + 40 * field, at least 1), and labels 1..N_CLASSES-1
    as equal-volume bands of that field inside it (0 outside)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    field = torch.randn((1, 1, DIM, DIM, DIM), generator=gen, device=dev)
    for _ in range(3):
        field = torch.nn.functional.avg_pool3d(field, 9, stride=1, padding=4)
    field = field[0, 0]
    field = (field - field.mean()) / field.std()
    ax = ((torch.arange(DIM, device=dev, dtype=torch.float32) - (DIM - 1) / 2)
          / (0.42 * DIM))
    fg = (ax[:, None, None] ** 2 + (ax[None, :, None] / 0.9) ** 2
          + (ax[None, None, :] / 0.8) ** 2) <= 1.0
    q = torch.arange(1, N_CLASSES - 1, device=dev) / (N_CLASSES - 1.0)
    bounds = torch.quantile(field[fg], q)
    vol = torch.where(fg, (100.0 + 40.0 * field).clamp_min(1.0), 0.0)
    lab = torch.where(fg, 1 + torch.bucketize(field, bounds), 0)
    return vol.cpu().numpy(), lab.to(torch.uint8).cpu().numpy()


def write_project(root, views, fusion, dev):
    """A two-image `mp predict` project in the JAX package's layout:
    train_hparams.yaml, views.npz, a JAX-format checkpoint of the main
    path's weights, fusion weights, and 256^3 structured images with
    labels."""
    data = root / "data" / "test"
    for sub in ("images", "labels"):
        (data / sub).mkdir(parents=True)
    for seed, name in enumerate(("subject_1", "subject_2")):
        vol, lab = structured_subject(dev, seed)
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
    (proj / "train_hparams.yaml").write_text(text)
    np.savez(proj / "views.npz", views)
    jax_format_unet_weights(proj / "model" / "@epoch_01_val_dice_0.10000.npz",
                            N_CLASSES, N_CHANNELS, DEPTH, CF, seed=0)
    np.savez(proj / "model" / "fusion_weights" / "unet_fusion_weights.npz",
             **{"params/fusion/W": fusion["fusion"]["W"],
                "params/fusion/b": fusion["fusion"]["b"]})
    return proj, data


def run_mp_predict_counted(proj, out, extra, expected):
    """One `mp predict` through its entry point, with the shear-pass count
    set to 0 just before it; each predict_image it makes is wrapped to
    read its own launches and remap modes. Gates: one call per image, each
    with `expected` launches and every view on the ungrouped shear remap.
    Returns (per-image timings, the launches of the run)."""
    calls = []
    original = MultiViewPredictor.predict_image

    def counted(self, image, *args, **kwargs):
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
        if n != expected or modes != ["shear"] * N_VIEWS:
            raise AssertionError(f"mp predict {out} {image_id}: {n} "
                                 f"shear-pass launches (expected {expected}),"
                                 f" remap modes {modes}")
    if len(calls) != len(timings) or launches != expected * len(timings):
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
    image taken apart. Returns the launches of both runs."""
    t0 = time.perf_counter()
    proj, data = write_project(Path(tmp), views, fusion, dev)
    log(f"mp predict project written in {time.perf_counter() - t0:.1f} s")
    expected = expected_launches(plans, ["shear"] * N_VIEWS)
    total = 0
    for out, extra in (("pred_eval", []),
                       ("pred_no_eval", ["--no_eval", "--continue"])):
        t0 = time.perf_counter()
        timings, launches = run_mp_predict_counted(proj, out, extra,
                                                   expected)
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
    return total


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


def main():
    dev = require_cuda()
    torch.manual_seed(0)
    card = phase_environment()
    # Shear-pass launches of each path, each counted from 0 just before it
    # (the kernel vs plain comparisons are not counted)
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        predictor, images, views, fusion, plans = setup_main_path(dev, tmp)
        err = phase_kernel_vs_plain(dev, plans)
        phase_oracle(dev)
        paths[f"main {DIM}^3"] = phase_main_path(dev, predictor, images, views,
                                              fusion)
        times = phase_timing(dev, plans)
        e, paths[f"grouped {DIM}^3"] = phase_grouped_remap(
            dev, predictor, images[0], views, fusion, plans)
        err = max(err, e)
        paths[f"gather {DIM}^3"] = phase_gather(dev, predictor, images[0],
                                             views, fusion)
        del images
        phase_u8(dev)
        paths["mp predict"] = phase_mp_predict(dev, predictor, views, fusion,
                                               plans, tmp)
        e, paths[f"{DIM_LARGE}^3"] = phase_large(dev, predictor.model, views, fusion)
        err = max(err, e)
    ms = times["stack"][0] + times["remap"][0]
    plain_ms = times["stack"][1] + times["remap"][1]
    log(f"shear-pass launches per path: {paths}")
    log(f"card: {card}")
    log(json.dumps({"kernels": [{
        "name": "shear_pass",
        "route": "cuda",
        "source": "multiplanarunet_tpu_torch/csrc/shear_pass.cu",
        "replaces": "multiplanarunet_tpu/ops/pallas_shear.py:131",
        "launches": sum(paths.values()),
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
