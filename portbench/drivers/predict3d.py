"""Driver of the 3D predict cell: `pred_3D_iso`, `mp predict_3D`'s box
inference, one volume after another (a closed loop, as `mp predict_3D`'s
main thread runs it), through `unet_predict_fn` over the configuration's
UNet3D.

Set-up makes the U-Net's weights on the card from the seed, scales its
out conv to the traffic's mean confidence (as the 2D predict cells do),
hands them to the port's loader, builds the box sampler `mp predict_3D`
builds (`IsotrophicLiveViewSequence3D` as validation: no orientation
noise), warms one volume of each protocol, and starts a producer thread
that hands out the window's volumes from (seed, index), `queue_ahead`
volumes ahead. Before each volume numpy's global stream is
seeded from (seed, index), so that its random boxes can be replayed.
The producer hands out `distinct_volumes` volumes made in set-up, in
turn: making a 256^3 volume takes the host about as long as predicting
it takes the card. A
volume is the base tiling plus `extra_boxes` random boxes in chunks of
`BOX_CHUNK`, its class map fetched. The window runs `seconds`, then the
volume in flight finishes. The check takes window volumes in an order
drawn from the seed and holds their class maps against the reference's
summed box probabilities (`portbench/reference/predict3d.py`), as the
2D predict cells hold theirs (`gap_vs_fp8`).
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch

from portbench import arith, traffic
from portbench.drivers import predict
from portbench.harness import TracedWindow
from portbench.reference import compare, unet
from portbench.reference import predict3d as ref3d


class Image:
    """What pred_3D_iso reads of an image: shape, affine, real extent and
    the port's sampler (no scaler: the volumes are made in scaled
    units)."""

    def __init__(self, volume, affine, sampler_cls):
        self.shape = volume.shape
        self.affine = affine
        self.real_shape = np.asarray(volume.shape[:3]) * ref3d.spacing_of(
            affine)
        self.interpolator = sampler_cls(volume, affine,
                                        bg_value=traffic.PREDICT_BG)


def calibrate_confidence(tree, build, seed, device, target, edge_mm):
    """Scale the out conv (kernel and bias) so that the U-Net's mean
    largest class probability over one dim^3 box of a calibration volume
    made from the seed is `target` (see `traffic.calibrate_confidence`,
    which does this over 2D planes)."""
    dim = int(build["dim"])
    vol = torch.as_tensor(traffic.predict_volume(
        [dim] * 3, [1.0] * 3, seed, "calibration", device, edge_mm),
        device=device)[..., 0]
    x = vol[None, None].contiguous()
    with unet.float32_mode(benchmark=False), torch.no_grad():
        z = unet.forward(tree["params"], tree["batch_stats"], x,
                         int(build["depth"]), logits=True)
    lo, hi = 1e-3, 1e3
    for _ in range(60):  # bisection on log scale; confidence rises with s
        mid = (lo * hi) ** 0.5
        conf = float(torch.softmax(mid * z, dim=1).amax(dim=1).mean())
        lo, hi = (mid, hi) if conf < target else (lo, mid)
    out = tree["params"]["out_conv"]
    out["kernel"].mul_(lo)
    out["bias"].mul_(lo)
    return lo


class Driver(predict.Driver):
    # ------------------------------------------------------------ inputs
    def box_seed(self, index):
        return traffic.derive(self.seed, "boxes", index) % 2 ** 32

    def volume(self, index, proto=None):
        """(volume, affine, protocol name) of window volume `index` (an
        int): the one of `distinct_volumes` that set-up made for index
        modulo their count (a 256^3 volume takes the host about as long
        to make as the card to predict); or of a warm-up volume (a tag)."""
        if not isinstance(index, int):
            return super().volume(index, proto)
        key = index % int(self.traffic["distinct_volumes"])
        if key not in self._made:
            self._made[key] = super().volume(key)
        return self._made[key]

    # ------------------------------------------------------------ set-up
    def setup(self):
        from multiplanarunet_tpu_torch.image.volume_sampler import (
            VolumeSampler,
        )
        from multiplanarunet_tpu_torch.logging.loggers import ScreenLogger
        from multiplanarunet_tpu_torch.models import checkpoint
        from multiplanarunet_tpu_torch.models.model_init import build_model
        from multiplanarunet_tpu_torch.sequences import (
            IsotrophicLiveViewSequence3D,
        )
        from multiplanarunet_tpu_torch.utils.fusion import fuse_and_predict

        torch.set_num_threads(predict.HOST_THREADS)
        build, fit = self.config["build"], self.config["fit"]
        self.sampler_cls = VolumeSampler
        self._made = {}
        for i in range(int(self.traffic["distinct_volumes"])):
            self.volume(i)
        self.variables = traffic.make_weights(build, self.seed, self.device)
        calibrate_confidence(self.variables, build, self.seed, self.device,
                             self.traffic["mean_confidence"],
                             self.traffic["edge_mm"])
        if self.device.type == "cuda":  # the peak is the program's
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)
        quiet = ScreenLogger(False)
        model = build_model(build, mixed_precision=fit["mixed_precision"],
                            logger=quiet)
        model.load_state_dict(checkpoint.unet_state_dict_from_jax(
            self.variables["params"], self.variables["batch_stats"], model))
        model = model.to(self.device).eval()
        self.sequence = IsotrophicLiveViewSequence3D(
            None, real_box_dim=fit["real_box_dim"], dim=build["dim"],
            batch_size=fuse_and_predict.BOX_CHUNK,
            n_classes=build["n_classes"], noise_sd=fit["noise_sd"],
            is_validation=True, logger=quiet, device=self.device,
            no_log=True)
        self.predict_fn = fuse_and_predict.unet_predict_fn(model,
                                                           self.device)
        self.pred_3D_iso = fuse_and_predict.pred_3D_iso
        if self.plant is not None:
            self.plant(self)
        for k, proto in enumerate(self.traffic["protocols"]):
            vol, affine, _ = self.volume(f"warm{k}", proto)
            self._predict(Image(vol, affine, VolumeSampler), f"warm{k}")
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

    def _predict(self, image, index):
        np.random.seed(self.box_seed(index))
        return self.pred_3D_iso(self.predict_fn, self.sequence, image,
                                extra_boxes=self.traffic["extra_boxes"],
                                want_argmax=True)

    def _boxes(self, shape, affine):
        fit = self.config["fit"]
        n_base = len(ref3d.base_corners(shape, affine,
                                        float(fit["real_box_dim"])))
        return n_base + ref3d.n_extra(self.traffic["extra_boxes"], n_base)

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
            cls = self._predict(image, index)
            wall = time.perf_counter() - tv
            n += 1
            if tracer is not None and tracer.active and n == trace_to:
                tracer.stop()
            self.maps.append(cls)
            vols.append({"index": index, "protocol": proto,
                         "shape": list(vol.shape[:3]), "wall_s": wall,
                         "boxes": self._boxes(vol.shape, affine)})
        t_end = time.perf_counter()
        if tracer is not None and tracer.active:
            tracer.stop()
        box_flops = arith.config_forward_flops(build)
        boxes = sum(v["boxes"] for v in vols) / len(vols)
        self.records.update({
            "attempted": n, "failed": 0, "window_s": t_end - t0,
            "volumes": vols, "boxes_per_volume": boxes,
            "unet_flops_per_volume": box_flops * boxes,
            "trace": tracer.summary() if tracer is not None else None})

    # ------------------------------------------------------------- check
    def release(self):
        """Stop the producer and free the program's state."""
        self._stop_producer()
        self.predict_fn = self.sequence = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, quant=None):
        """`gap_vs_fp8` and the class-map numbers of window volumes (in an
        order drawn from the seed) against the reference's summed box
        probabilities, as the 2D predict cells read theirs
        (`portbench/drivers/predict.py:Driver.check`): volumes are added
        until fp8's mean gap reaches `compare.GAP_FLOOR`, or
        `compare.MAX_VOLUMES` are checked; `quant` puts the reference at
        that precision in the program's place."""
        rng = np.random.default_rng(traffic.derive(self.seed, "check"))
        order = rng.permutation(len(self.maps))[:compare.MAX_VOLUMES]
        build, fit = self.config["build"], self.config["fit"]
        sums = {"program": 0.0, "fp8": 0.0, "voxels": 0}
        first, checked = None, []
        for i in order:
            vol, affine, proto = self.volume(int(i))
            args = (vol, affine, self.variables, int(build["depth"]),
                    int(build["dim"]), float(fit["real_box_dim"]),
                    self.traffic["extra_boxes"], self.box_seed(int(i)),
                    traffic.PREDICT_BG, self.device)
            score = ref3d.scores(*args)
            fp8_cls = ref3d.scores(*args, quant="fp8").argmax(-1)
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


# ------------------------------------------------------------------ faults
# Faults planted under the program for the tests that show a broken timed
# path comes out not correct (`Driver(plant=...)`).
def skipped_boxes(driver):
    """Half of the batch left out: the scatter of every other chunk of
    boxes is skipped."""
    from multiplanarunet_tpu_torch.utils.fusion import fuse_and_predict

    inner = fuse_and_predict.scatter_box_pred
    calls = [0]

    def skipping(pred_vol, *args, **kwargs):
        calls[0] += 1
        if calls[0] % 2:
            return inner(pred_vol, *args, **kwargs)
        return pred_vol

    def pred_3D_iso(*args, **kwargs):
        fuse_and_predict.scatter_box_pred = skipping
        try:
            return driver_pred(*args, **kwargs)
        finally:
            fuse_and_predict.scatter_box_pred = inner

    driver_pred = driver.pred_3D_iso
    driver.pred_3D_iso = pred_3D_iso


def altered_answer(driver):
    """An answer altered where it is produced: in each class map, the
    voxels of one slab of SLAB planes across the middle of the first axis
    take the next class."""
    inner = driver.pred_3D_iso
    n = int(driver.config["build"]["n_classes"])

    def altered(*args, **kwargs):
        cls = inner(*args, **kwargs).copy()
        x0 = cls.shape[0] // 2
        cls[x0:x0 + predict.SLAB] = (cls[x0:x0 + predict.SLAB].astype(
            np.int64) + 1) % n
        return cls

    driver.pred_3D_iso = altered


def unchanged_state(driver):
    """A step that returns its state unchanged: no box reaches the
    accumulator, so each class map is the argmax of zeros (class 0)."""
    inner = driver.pred_3D_iso

    def unchanged(*args, **kwargs):
        return np.zeros_like(inner(*args, **kwargs))

    driver.pred_3D_iso = unchanged


FAULTS = {"skipped_boxes": skipped_boxes, "altered_answer": altered_answer,
          "unchanged_state": unchanged_state}
