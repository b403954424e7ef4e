"""Driver of the predict cells: `MultiViewPredictor.predict_image`, one
volume after another (a closed loop, as `mp predict`'s main thread runs
it), fused over the configuration's views with learned fusion weights.

Set-up makes the U-Net's weights on the card from the seed and hands
them to the port's loader (`models/checkpoint.py`), builds the predictor
in its default form (shear resampler, dilated + lane-padded U-Net, bf16
staging), warms one volume of each protocol of the traffic, and starts
a producer thread that makes the window's volumes on the host from (seed,
index), `queue_ahead` volumes ahead, as `mp predict`'s input thread
loads them. The window runs `seconds`, then the volume in flight
finishes. The check takes the window's volumes in an order drawn from
the seed, one to three of them (`check`), and holds their class maps
against the reference's fused scores (`portbench/reference/predict.py`).
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch

from portbench import arith, traffic
from portbench.harness import TracedWindow
from portbench.reference import compare
from portbench.reference import predict as ref_predict

# Host threads for the producer's volumes (torch's CPU ops)
HOST_THREADS = 2


class Image:
    """What predict_image reads of an image: shape, affine and the port's
    sampler (no scaler: the volumes are made in scaled units)."""

    def __init__(self, volume, affine, sampler_cls):
        self.shape = volume.shape
        self.affine = affine
        self.interpolator = sampler_cls(volume, affine,
                                        bg_value=traffic.PREDICT_BG)


class Driver:
    def __init__(self, cell, config, workload, seed, device, trace,
                 plant=None):
        self.cell = cell
        self.config = config
        self.traffic = workload["traffic"]
        self.seed = int(seed)
        self.device = torch.device(device)
        self.trace = trace
        # A test's fault, planted under the program before its first use
        self.plant = plant
        self.records = {"kind": "predict", "attempted": 0, "failed": 0}
        self._stop = threading.Event()
        self._queue = None
        self._thread = None
        self.maps = []

    # ------------------------------------------------------------ inputs
    def volume(self, index, proto=None):
        """(volume, affine, protocol name) of window volume `index` (an
        int), or of a warm-up volume (a tag) of the given protocol."""
        draw_proto, affine = traffic.draw_volume(self.traffic, self.seed,
                                                 index)
        proto = proto or draw_proto
        vol = traffic.predict_volume(proto["shape"], proto["spacing"],
                                     self.seed, index,
                                     edge_mm=self.traffic["edge_mm"])
        return vol, affine, proto["name"]

    def _produce(self):
        try:
            i = 0
            while not self._stop.is_set():
                item = (i,) + self.volume(i)
                while not self._stop.is_set():
                    try:
                        self._queue.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                i += 1
        except BaseException as e:  # handed to the window, which raises
            self._queue.put(e)
            raise

    def _next(self):
        item = self._queue.get()
        if isinstance(item, BaseException):
            raise RuntimeError("the volume producer failed") from item
        return item

    # ------------------------------------------------------------ set-up
    def setup(self):
        from multiplanarunet_tpu_torch.image.volume_sampler import (
            VolumeSampler,
        )
        from multiplanarunet_tpu_torch.logging.loggers import ScreenLogger
        from multiplanarunet_tpu_torch.models import checkpoint
        from multiplanarunet_tpu_torch.models.model_init import build_model
        from multiplanarunet_tpu_torch.utils.fusion.fuse_and_predict import (
            MultiViewPredictor,
        )

        torch.set_num_threads(HOST_THREADS)
        build, fit = self.config["build"], self.config["fit"]
        self.sampler_cls = VolumeSampler
        self.variables = traffic.make_weights(build, self.seed, self.device)
        traffic.calibrate_confidence(
            self.variables, build, self.seed, self.device,
            self.traffic["mean_confidence"], self.traffic["edge_mm"])
        if self.device.type == "cuda":  # the peak is the program's
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)
        model = build_model(build, mixed_precision=fit["mixed_precision"],
                            logger=ScreenLogger(False))
        model.load_state_dict(checkpoint.unet_state_dict_from_jax(
            self.variables["params"], self.variables["batch_stats"], model))
        model = model.to(self.device).eval()
        self.views = traffic.random_views(
            int(fit["views"]), self.traffic["min_view_angle_deg"],
            np.random.RandomState(self.traffic["views_seed"]))
        W, b = traffic.fusion_weights(len(self.views), build["n_classes"],
                                      self.seed)
        self.fusion = {"fusion": {"W": W, "b": b}}
        self.predictor = MultiViewPredictor(
            model, sample_dim=build["dim"],
            real_space_span=fit["real_space_span"],
            n_classes=build["n_classes"], device=self.device)
        self.n_planes = self.traffic["n_planes"]
        if self.plant is not None:
            self.plant(self)
        # Warm-up: one volume of each protocol
        for k, proto in enumerate(self.traffic["protocols"]):
            vol, affine, _ = self.volume(f"warm{k}", proto)
            self._predict(Image(vol, affine, VolumeSampler))
        if self.trace and self.device.type == "cuda":
            TracedWindow(torch).prime()
        self._queue = queue.Queue(maxsize=int(self.traffic["queue_ahead"]))
        self._thread = threading.Thread(target=self._produce,
                                        name="portbench-volumes",
                                        daemon=True)
        self._thread.start()
        while self._queue.qsize() < self._queue.maxsize:
            if not self._thread.is_alive():
                self._next()
            time.sleep(0.01)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _predict(self, image):
        fused, _ = self.predictor.predict_image(
            image, self.views, fusion_params=self.fusion,
            n_planes=self.n_planes, return_per_view=False)
        return fused

    # ------------------------------------------------------------ window
    def window(self, seconds):
        build = self.config["build"]
        tracer = TracedWindow(torch) if (
            self.trace and self.device.type == "cuda") else None
        trace_from, trace_to = self.traffic.get("trace_volumes", [1, 3])
        vols = []
        t0 = time.perf_counter()
        n = 0
        while n == 0 or time.perf_counter() - t0 < seconds:
            index, vol, affine, proto = self._next()
            image = Image(vol, affine, self.sampler_cls)
            if tracer is not None and n == trace_from:
                tracer.start()
            tv = time.perf_counter()
            fused = self._predict(image)
            wall = time.perf_counter() - tv
            stage = self.predictor.stage_ms() if self.trace else {}
            n += 1
            if tracer is not None and tracer.active and n == trace_to:
                tracer.stop()
            self.maps.append(fused)
            vols.append({"index": index, "protocol": proto,
                         "shape": list(vol.shape[:3]), "wall_s": wall,
                         "stage_ms": stage})
        t_end = time.perf_counter()
        if tracer is not None and tracer.active:
            tracer.stop()
        n_valid = len(ref_predict.plane_offsets(
            self.n_planes, float(self.config["fit"]["real_space_span"]),
            int(build["dim"])))
        n_views = len(self.views)
        flops = arith.config_forward_flops(build) * n_views * n_valid
        for v in vols:
            v["resample_bytes"], v["resample_flops"] = arith.resample_work(
                v["shape"], int(build["n_channels"]), int(build["dim"]),
                n_valid, n_views, int(build["n_classes"]))
        self.records.update({
            "attempted": n, "failed": 0, "window_s": t_end - t0,
            "volumes": vols, "unet_flops_per_volume": flops,
            "trace": tracer.summary() if tracer is not None else None})

    # ------------------------------------------------------------- check
    def release(self):
        """Stop the producer and free the program's state."""
        self._stop_producer()
        self.predictor = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _stop_producer(self):
        self._stop.set()
        if self._thread is not None:
            while self._thread.is_alive():
                try:
                    self._queue.get_nowait()
                except queue.Empty:
                    pass
                self._thread.join(timeout=0.05)
            self._thread = None

    def check(self, quant=None):
        """Numbers of window volumes (in an order drawn from the seed)
        against the reference. `gap_vs_fp8` is the program's gap summed
        over the volumes checked, over that of the reference computed in
        fp8 on the same volumes: how far a seed's random weights let
        rounding move the class map varies a hundredfold from seed to
        seed, and the fp8 computation measures it on the volumes at
        hand. Volumes are added until fp8's mean gap over them reaches
        `compare.GAP_FLOOR`, or `compare.MAX_VOLUMES` are checked.
        `quant` puts the reference at that precision in the program's
        place (the control), which reads 1 on `gap_vs_fp8` wherever fp8
        moves the class map at all; the program's own reading goes
        beside it."""
        rng = np.random.default_rng(traffic.derive(self.seed, "check"))
        order = rng.permutation(len(self.maps))[:compare.MAX_VOLUMES]
        build, fit = self.config["build"], self.config["fit"]
        sums = {"program": 0.0, "fp8": 0.0, "voxels": 0}
        first, checked = None, []
        for i in order:
            vol, affine, proto = self.volume(int(i))
            args = (vol, affine, self.views, self.fusion["fusion"]["W"],
                    self.fusion["fusion"]["b"], self.variables,
                    int(build["depth"]), int(build["dim"]),
                    float(fit["real_space_span"]), self.n_planes,
                    traffic.PREDICT_BG, self.device)
            score = ref_predict.fused_scores(*args)
            fp8_cls = ref_predict.fused_scores(*args, quant="fp8").argmax(-1)
            fp8 = compare.class_map_gaps(fp8_cls, score)
            prog = compare.class_map_gaps(torch.from_numpy(self.maps[i]),
                                          score)
            del score, fp8_cls
            n = int(np.prod(vol.shape[:3]))
            sums["program"] += prog["gap_mean"] * n
            sums["fp8"] += fp8["gap_mean"] * n
            sums["voxels"] += n
            checked.append({"volume": int(i), "protocol": proto,
                            "gap_mean": prog["gap_mean"],
                            "fp8_gap_mean": fp8["gap_mean"]})
            if first is None:
                first = fp8 if quant is not None else prog
            if sums["fp8"] / sums["voxels"] >= compare.GAP_FLOOR:
                break
        numbers = dict(first)
        numbers["fp8_gap_mean"] = sums["fp8"] / sums["voxels"]
        mine = sums["fp8"] if quant is not None else sums["program"]
        numbers["gap_vs_fp8"] = compare.gap_ratio(mine, sums["fp8"])
        return numbers, {"checked": checked,
                         "program_gap_vs_fp8": compare.gap_ratio(
                             sums["program"], sums["fp8"])}

    def close(self):
        self._stop_producer()


# ------------------------------------------------------------------ faults
# Faults planted under the program for the tests that show a broken timed
# path comes out not correct (`Driver(plant=...)`): each takes the driver
# once the program is built and before its first use.
SLAB = 16


def half_views(driver):
    """Half of the batch left out: every volume fused over the first half
    of the views only, their weights scaled so that the sum stands for
    the mean over the rest."""
    inner = driver.predictor.predict_image

    def half(image, views, fusion_params=None, **kwargs):
        k = len(views) // 2
        W = np.asarray(fusion_params["fusion"]["W"])
        fp = {"fusion": {"W": W[:k] * (len(views) / k),
                         "b": fusion_params["fusion"]["b"]}}
        return inner(image, views[:k], fusion_params=fp, **kwargs)

    driver.predictor.predict_image = half


def altered_answer(driver):
    """An answer altered where it is produced: in each class map, the
    voxels of one slab of SLAB planes across the middle of the first axis
    take the next class."""
    inner = driver.predictor.predict_image
    n = int(driver.config["build"]["n_classes"])

    def altered(*args, **kwargs):
        fused, per_view = inner(*args, **kwargs)
        fused = fused.copy()
        x0 = fused.shape[0] // 2
        fused[x0:x0 + SLAB] = (fused[x0:x0 + SLAB].astype(np.int64) + 1) % n
        return fused, per_view

    driver.predictor.predict_image = altered


def unchanged_state(driver):
    """A step that returns its state unchanged: no view reaches the fusion
    accumulator, so each class map is the argmax of the bias alone."""
    inner = driver.predictor.predict_image

    def unchanged(image, views, fusion_params=None, **kwargs):
        fused, per_view = inner(image, views, fusion_params=fusion_params,
                                **kwargs)
        b = np.asarray(fusion_params["fusion"]["b"]).reshape(-1)
        return np.full_like(fused, int(np.argmax(b))), per_view

    driver.predictor.predict_image = unchanged


FAULTS = {"half_views": half_views, "altered_answer": altered_answer,
          "unchanged_state": unchanged_state}
