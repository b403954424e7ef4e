#!/usr/bin/env python3
"""Smoke run of the PyTorch port (multiplanarunet_tpu_torch) on one NVIDIA
GPU: builds the CUDA shear-pass kernel from csrc/, holds it against its
plain PyTorch version, checks the predictor's geometry with a one-hot
oracle, then drives fused multi-view inference at full width (U-Net
complexity_factor 2, depth 4, dim 256, 7 classes; 6 views + learned
fusion over 256^3 volumes, bench.py's configuration) and times it.

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
from multiplanarunet_tpu_torch.image.volume_sampler import VolumeSampler
from multiplanarunet_tpu_torch.models import checkpoint
from multiplanarunet_tpu_torch.models.unet import UNet
from multiplanarunet_tpu_torch.ops import _build, geometry
from multiplanarunet_tpu_torch.ops.shear import shear_resample
from multiplanarunet_tpu_torch.ops.shear_pass import (
    shear_pass,
    shear_pass_reference,
)
from multiplanarunet_tpu_torch.ops.shear_plan import plan_affine_resample
from multiplanarunet_tpu_torch.utils.fusion.fuse_and_predict import (
    MultiViewPredictor,
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
    """Feed every pass of `plan` the same random input (drawn on the card
    from `gen`) through the kernel and the plain version; returns the max
    abs difference."""
    err = 0.0
    for i, op in enumerate(plan.ops):
        shape = [ext for (_, ext) in plan.stages[i]] + [channels]
        A = torch.rand(shape, generator=gen, device=gen.device).to(dtype)
        got = shear_pass(A, op, method)
        want = shear_pass_reference(A, op, method)
        torch.cuda.synchronize()
        if not torch.isfinite(got.float()).all():
            raise AssertionError("kernel output holds non-finite values")
        err = max(err, (got.float() - want.float()).abs().max().item())
    if err > TOL[dtype]:
        raise AssertionError(f"kernel vs plain: max abs err {err} > "
                             f"{TOL[dtype]} ({method}, {dtype})")
    return err


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
    for v, ((s_plan, _), (r_plan, _)) in enumerate(main_plans):
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


def phase_oracle(dev):
    size, nc = 64, 4
    lab = np.zeros((size, size, size), np.uint8)
    lab[8:28, 10:30, 12:34] = 1
    lab[34:54, 14:40, 20:44] = 2
    lab[14:30, 36:56, 38:58] = 3
    lab[40:50, 44:58, 6:18] = 1
    img = Image(lab.astype(np.float32)[..., None], np.eye(4))
    pred = MultiViewPredictor(OneHotOracle(nc), sample_dim=size,
                              real_space_span=float(size - 2), n_classes=nc,
                              device=dev)
    views = geometry.get_random_views(4, rng=np.random.RandomState(3))
    fused, per_view = pred.predict_image(img, views, n_planes="same+20",
                                         return_probs=True)
    if fused.shape != lab.shape + (nc,) or not np.isfinite(fused).all():
        raise AssertionError(f"oracle output shape {fused.shape}")
    sum_err = float(np.abs(fused.sum(-1) - 1.0).max())
    interior = np.zeros_like(lab, bool)
    interior[2:-2, 2:-2, 2:-2] = True
    acc = float((fused.argmax(-1) == lab)[interior].mean())
    acc_v = [float((pv == lab)[interior].mean()) for pv in per_view]
    log(f"oracle 64^3, 4 views: fused interior accuracy {acc:.4f} "
        f"(> 0.95), per-view {[round(a, 4) for a in acc_v]}, fused "
        f"probability sum max |err| {sum_err:.3g} (< 1e-2)")
    if acc <= 0.95 or sum_err >= 1e-2:
        raise AssertionError("oracle reconstruction failed")


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
    img = images[0]
    true_shape = tuple(img.shape[:3])
    offsets, n_valid = predictor._prepare_offsets(img, "same+20")
    bases = [geometry.plane_basis(v) for v in views]
    Mts = [predictor._remap_transform(img, b, true_shape) for b in bases]
    plans = predictor._plan_shear_views(img, bases, Mts, offsets, n_valid)
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
    path's shapes, kernel vs plain, alternating plain/kernel/kernel/plain."""
    (s_plan, _), (r_plan, _) = plans[0]
    out = {}
    for name, plan, method, ch in (("stack", s_plan, "cubic", N_CHANNELS + 1),
                                   ("remap", r_plan, "linear",
                                    N_CLASSES + 1)):
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


def main():
    dev = require_cuda()
    torch.manual_seed(0)
    card = phase_environment()
    with tempfile.TemporaryDirectory() as tmp:
        predictor, images, views, fusion, plans = setup_main_path(dev, tmp)
    err = phase_kernel_vs_plain(dev, plans)
    phase_oracle(dev)
    launches = phase_main_path(dev, predictor, images, views, fusion)
    times = phase_timing(dev, plans)
    ms = times["stack"][0] + times["remap"][0]
    plain_ms = times["stack"][1] + times["remap"][1]
    log(f"card: {card}")
    log(json.dumps({"kernels": [{
        "name": "shear_pass",
        "route": "cuda",
        "source": "multiplanarunet_tpu_torch/csrc/shear_pass.cu",
        "replaces": "multiplanarunet_tpu/ops/pallas_shear.py:131",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
