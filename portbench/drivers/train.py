"""Driver of the training cells: `Trainer.fit` over the training sequence
that `mp train`'s data preparation builds for the configuration (the
pooled plane or box sampler, the preset's Elastic augmenter, one-deep
prefetch), at the configuration's batch.

Set-up makes the subjects on the card from the seed and writes them as
uncompressed NIfTI under TMPDIR, builds a project from the port's preset
with the configuration's groups (no validation, no callbacks), makes the
U-Net's weights on the card from the seed and hands them to the port's
loader, and compiles the Trainer. It then drives that same Trainer
through its first steps by `fit` (`warm_epochs` epochs of
`warm_steps_per_epoch` steps, so an epoch boundary is warm too). The
window is one more `fit` call, from an epoch boundary, with the
configuration's images per epoch; it ends at the step in flight when
`seconds` have passed (and not before its first three steps), after a
synchronise.

What the check reads is kept on the way, for two stretches of three
steps: the first three steps of set-up (from the seed's weights) and
the first three of the window (from the state the window starts with:
the parameters and the optimizer's moments and count, copied before its
first step). Of each: the batches, the losses, the optimizer's first
moment after the first step and the parameters after the third. Of the
window's three batches also what the sampler made on the way (hooks
under the sequence): the planes or boxes before the augmenter, where
they lie (subject, basis and offset, or corner and rotation) and the
augmenter's batch count and draws. The check runs the reference's three
steps (`portbench/reference/unet.py:train_steps`) over each stretch's
batches from its start, and the reference sampler
(`portbench/reference/sampler.py`) over the window's batches.
"""

from __future__ import annotations

import collections
import copy
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from portbench import arith, traffic
from portbench.harness import TracedWindow
from portbench.reference import compare, sampler, unet

N_CHECKED = 3
# The step numbers compared: the worse of the two stretches
STEP_NUMBERS = ("out_grad_err", "grad_gap_median", "update_gap")


class WindowClosed(Exception):
    """Raised by the step recorder when the window's time is up."""


class TimedSequence:
    """The program's training sequence as Trainer.fit sees it, with the
    host wall of each sequence[i] kept (the prefetch worker's sampling
    time). Once the sampler's hooks are in (`Driver._hook_sampler`),
    what they record of a batch is kept by the identity of its images
    (the last few batches), for `take`. Attributes read or set pass
    through to the sequence."""

    def __init__(self, seq):
        object.__setattr__(self, "_seq", seq)
        object.__setattr__(self, "seconds", [])
        object.__setattr__(self, "pending", None)
        object.__setattr__(self, "made", collections.OrderedDict())

    def __getitem__(self, i):
        object.__setattr__(self, "pending", {})
        t = time.perf_counter()
        batch = self._seq[i]
        self.seconds.append(time.perf_counter() - t)
        if self.pending:
            self.made[id(batch[0])] = self.pending
            while len(self.made) > 4:
                self.made.popitem(last=False)
        return batch

    def take(self, x):
        """What the hooks recorded of the batch whose images are x."""
        return self.made.pop(id(x), None)

    def __getattr__(self, name):
        return getattr(self._seq, name)

    def __setattr__(self, name, value):
        setattr(self._seq, name, value)


def flax_path(name):
    """('encoder_L0', 'conv1', 'kernel') for the port's parameter
    'encoder_L0.conv1.weight' (a BatchNorm's weight is its scale)."""
    *mods, leaf = name.split(".")
    norm = mods[-1] == "bn" or mods[-1].endswith("_bn_up")
    if leaf == "weight":
        leaf = "scale" if norm else "kernel"
    return tuple(mods) + (leaf,)


def _stretch():
    return {"batches": [], "losses": [None] * N_CHECKED, "sampler": []}


class StepRecorder:
    """Stands in for the Trainer's train step: calls it, records a CUDA
    event before and after each call on the caller's stream, keeps what
    the check needs of the checked steps, runs the traced stretch, and
    raises WindowClosed once the window's time is up."""

    def __init__(self, step, driver):
        self.step = step
        self.driver = driver
        self.count = 0
        self.deadline = None
        self.window_first = None
        self.events = []
        self.tracer = None
        self.trace_span = None

    def _event(self):
        if self.driver.device.type != "cuda":
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def __call__(self, x, y, w):
        k = self.count
        d = self.driver
        j = None if self.window_first is None else k - self.window_first
        if k < N_CHECKED:
            d.start["batches"].append((x, y, w))
        if j is not None and j < N_CHECKED:
            if j == 0:
                d.keep_state(d.win)
            d.win["batches"].append((x, y, w))
            d.win["sampler"].append(d.sequence.take(x))
        if self.tracer is not None and j == self.trace_span[0]:
            self.tracer.start()
        start = self._event()
        logs = self.step(x, y, w)
        end = self._event()
        self.count += 1
        if j is not None:
            self.events.append((start, end))
        if k < N_CHECKED:
            d.keep_step(d.start, k, logs)
        if j is not None and j < N_CHECKED:
            d.keep_step(d.win, j, logs)
        if (self.tracer is not None and self.tracer.active
                and j + 1 == self.trace_span[1]):
            self.tracer.stop()
        if (self.deadline is not None and j >= N_CHECKED - 1
                and time.perf_counter() >= self.deadline):
            raise WindowClosed
        return logs


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
        self.records = {"kind": "train", "attempted": 0, "failed": 0}
        self.tmp = None
        self.start = _stretch()
        self.win = _stretch()

    # ------------------------------------------------------------ set-up
    def _write_subjects(self, data):
        from multiplanarunet_tpu_torch.io import nifti

        tr = self.traffic
        affine = np.diag(list(tr["subject_spacing"]) + [1.0])
        for sub in ("images", "labels"):
            (data / sub).mkdir(parents=True)
        for i in range(int(self.config["train_subjects"])):
            vol, lab = self._subject(i)
            nifti.save(vol.cpu().numpy(), data / "images" / f"s{i}.nii",
                       affine)
            nifti.save(lab.cpu().numpy(), data / "labels" / f"s{i}.nii",
                       affine)

    def _subject(self, i):
        tr = self.traffic
        return traffic.structured_subject(
            tr["subject_shape"], tr["subject_spacing"], self.seed, i,
            self.device, int(self.config["build"]["n_classes"]))

    def _hparams(self, proj, data):
        import multiplanarunet_tpu_torch
        from multiplanarunet_tpu_torch.hyperparameters.hparams import (
            YAMLHParams,
        )

        preset = (Path(multiplanarunet_tpu_torch.__file__).parent / "bin"
                  / "defaults" / self.config["preset"]
                  / "train_hparams.yaml")
        shutil.copyfile(preset, proj / "train_hparams.yaml")
        hp = YAMLHParams(proj / "train_hparams.yaml", logger=self.quiet,
                         no_log=True, no_version_control=True)
        hp["build"].update(copy.deepcopy(self.config["build"]))
        hp["fit"].update(copy.deepcopy(self.config["fit"]))
        self.aug_seeds = []
        for i, aug in enumerate(hp["fit"].get("augmenters") or []):
            aug["kwargs"]["seed"] = traffic.derive(self.seed, "augmenter",
                                                   i) % 2 ** 31
            self.aug_seeds.append(aug["kwargs"]["seed"])
        hp["fit"]["callbacks"] = []
        for split in ("train_data", "val_data"):
            hp[split]["base_dir"] = str(data)
        return hp

    def setup(self):
        from multiplanarunet_tpu_torch.logging.loggers import ScreenLogger
        from multiplanarunet_tpu_torch.models import checkpoint
        from multiplanarunet_tpu_torch.models.model_init import build_model
        from multiplanarunet_tpu_torch.preprocessing.data_preparation_funcs \
            import PREPARATION_FUNCS
        from multiplanarunet_tpu_torch.train.trainer import Trainer

        self.quiet = ScreenLogger(False)
        build, fit = self.config["build"], self.config["fit"]
        self.tmp = Path(tempfile.mkdtemp(prefix=f"portbench-{self.cell}-"))
        data, proj = self.tmp / "data", self.tmp / "project"
        proj.mkdir()
        self._write_subjects(data)
        hp = self._hparams(proj, data)
        np.random.seed(traffic.derive(self.seed, "numpy") % 2 ** 32)
        train, _ = PREPARATION_FUNCS[build["model_class_name"]](
            hparams=hp, no_val=True, logger=self.quiet, base_path=str(proj),
            device=self.device)
        # The sampler seeds numpy once per process; after that, the seed's
        train.seed()
        np.random.seed(traffic.derive(self.seed, "sampler") % 2 ** 32)
        self.sequence = TimedSequence(train)

        self.variables = traffic.make_weights(build, self.seed, self.device)
        model = build_model(build, mixed_precision=fit["mixed_precision"],
                            logger=self.quiet)
        model.load_state_dict(checkpoint.unet_state_dict_from_jax(
            self.variables["params"], self.variables["batch_stats"], model))
        self.trainer = Trainer(model, logger=self.quiet, device=self.device)
        self.trainer.compile_model(
            optimizer=fit["optimizer"],
            optimizer_kwargs=fit.get("optimizer_kwargs"), loss=fit["loss"],
            metrics=fit.get("metrics"), loss_kwargs=fit.get("loss_kwargs"))
        opt = self.trainer.optimizer
        # The packed vector's layout, to read its leaves after release
        self.layout = [(flax_path(name), tuple(p.shape), off)
                       for (name, p), off in zip(model.named_parameters(),
                                                 opt.packed.offsets)]
        self.recorder = StepRecorder(self.trainer.train_step, self)
        self.trainer.train_step = self.recorder
        if self.plant is not None:
            self.plant(self)
        if self.trace and self.device.type == "cuda":
            TracedWindow(torch).prime()
        self.batch = int(fit["batch_size"])
        tr = self.traffic
        self.trainer.fit(self.sequence, None, batch_size=self.batch,
                         n_epochs=int(tr["warm_epochs"]), callbacks=[],
                         train_im_per_epoch=self.batch
                         * int(tr["warm_steps_per_epoch"]),
                         verbose=False, no_im=True)
        self._hook_sampler()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _hook_sampler(self):
        """Record, for each batch the sequence makes from here on, the
        planes or boxes before the augmenter, their subjects and
        positions, and the augmenter's batch count and draws."""
        ts = self.sequence
        seq = ts._seq
        pool = seq._get_pool()
        slot_ids = {}
        ensure, pool_images = pool.ensure, seq._pool_images

        def ensure_hook(image):
            slot = ensure(image)
            slot_ids[int(slot)] = image.identifier
            return slot

        def pool_images_hook(pool_, params, *positions):
            out = pool_images(pool_, params, *positions)
            ts.pending.update(
                images=out, positions=[np.array(p) for p in positions],
                subjects=[slot_ids[int(s)] for s in params["slots"]])
            return out

        pool.ensure = ensure_hook
        seq._pool_images = pool_images_hook
        for aug in seq.list_of_augmenters or ():
            host = aug.draw_batch_params_host

            def host_hook(batch_size, host=host):
                out = host(batch_size)
                ts.pending.setdefault("draws", []).append(out)
                return out

            aug.draw_batch_params_host = host_hook

    def keep_state(self, st):
        """Copy the state a stretch starts from: the packed parameters,
        the optimizer's moments and its count."""
        opt = self.trainer.optimizer
        st["p0"] = opt.packed.data.clone()
        st["mu0"] = opt.state["mu"].float().clone()
        st["nu0"] = opt.state["nu"].float().clone()
        st["count0"] = int(opt.count)

    def keep_step(self, st, k, logs):
        """Keep what the check reads of a stretch's step k (0-based): its
        loss; after step 0 the first moment; after the last step the
        parameters, before the next step changes them."""
        opt = self.trainer.optimizer
        st["losses"][k] = logs["loss"].detach().clone()
        if k == 0:
            st["mu1"] = opt.state["mu"].float().clone()
            st["b1"] = float(opt.b1)
        if k == N_CHECKED - 1:
            st["after"] = opt.packed.data.clone()

    # ------------------------------------------------------------ window
    def window(self, seconds):
        rec = self.recorder
        tr = self.traffic
        per_epoch = max(1, int(self.config["train_images_per_epoch"]
                               / self.batch))
        if self.trace and self.device.type == "cuda":
            rec.tracer = TracedWindow(torch)
            before = int(tr["trace_steps_before_boundary"])
            rec.trace_span = (per_epoch - before,
                              per_epoch - before + int(tr["trace_steps"]))
        n_seq = len(self.sequence.seconds)
        rec.window_first = rec.count
        t0 = time.perf_counter()
        rec.deadline = t0 + float(seconds)
        try:
            self.trainer.fit(self.sequence, None, batch_size=self.batch,
                             n_epochs=10 ** 9, callbacks=[],
                             train_im_per_epoch=int(
                                 self.config["train_images_per_epoch"]),
                             verbose=False, no_im=True)
            raise RuntimeError("the window's fit ended before its time")
        except WindowClosed:
            pass
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t_end = time.perf_counter()
        if rec.tracer is not None and rec.tracer.active:
            rec.tracer.stop()
        steps = rec.count - rec.window_first
        step_ms, between_ms = [], []
        if self.device.type == "cuda":
            step_ms = [a.elapsed_time(b) for a, b in rec.events]
            ends = [b for _, b in rec.events]
            between_ms = [a.elapsed_time(b) for a, b in zip(ends, ends[1:])]
        self.records.update({
            "attempted": steps, "failed": 0, "window_s": t_end - t0,
            "samples": steps * self.batch, "steps_per_epoch": per_epoch,
            "step_ms": step_ms, "between_ms": between_ms,
            "sampler_s": self.sequence.seconds[n_seq:],
            "forward_flops_per_sample":
                arith.config_forward_flops(self.config["build"]),
            "trace": rec.tracer.summary() if rec.tracer else None})

    def _fields(self, made):
        """The augmenter's noise fields of a checked batch: the draws of
        the augmenter's key for its batch count (the reference deforms
        with them)."""
        if not made or len(made.get("draws", ())) != 1 \
                or len(self.aug_seeds) != 1:
            return None
        from multiplanarunet_tpu_torch.ops import elastic, prng

        count = int(made["draws"][0][0])
        key = prng.fold_in(prng.PRNGKey(self.aug_seeds[0]), count)
        images = made["images"]
        return elastic.noise_fields(key, images.dim() - 2, images)

    # ------------------------------------------------------------- check
    def release(self):
        """Free the program's state (the trainer, its model, optimizer and
        the sampler's device pool); what the check reads stays."""
        self.trainer = self.recorder = self.sequence = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _leaves(self, vector):
        """{flax path: tensor} of a vector in the optimizer's packed
        layout."""
        out = {}
        for path, shape, off in self.layout:
            leaf = vector[off:off + int(np.prod(shape))].view(shape)
            if len(shape) > 2:  # (O, I, *k) -> flax's (*k, I, O)
                leaf = leaf.permute(tuple(range(2, len(shape))) + (1, 0))
            out[path] = leaf
        return out

    def _tree(self, vector):
        return unet.rebuild([(p, v.clone()) for p, v in
                             self._leaves(vector).items()])

    def _opt(self):
        ok = self.config["fit"]["optimizer_kwargs"]
        return (float(ok["lr"]), float(ok["beta_1"]), float(ok["beta_2"]),
                float(ok["epsilon"]))

    def reference(self, st, quant=None):
        """The reference's (losses, first gradient, parameters after) over
        a stretch's batches, from the seed's weights (the start) or from
        the state the window started with."""
        variables, state = self.variables, None
        if "p0" in st:
            variables = {"params": self._tree(st["p0"]),
                         "batch_stats": self.variables["batch_stats"]}
            state = (self._tree(st["mu0"]), self._tree(st["nu0"]),
                     st["count0"])
        # cuDNN's search over float32 Conv3d algorithms costs minutes
        three_d = self.config["build"]["model_class_name"] == "UNet3D"
        with unet.float32_mode(benchmark=not three_d):
            return unet.train_steps(variables, st["batches"][:N_CHECKED],
                                    int(self.config["build"]["depth"]),
                                    self._opt(), quant=quant, state=state)

    def _program(self, st):
        """The program's (losses, first gradient, parameters after) of a
        stretch; the gradient from the first moment before and after the
        first step: (mu1 - b1 mu0) / (1 - b1)."""
        b1 = np.float32(st["b1"])
        mu0 = st.get("mu0")
        g = st["mu1"].double()
        if mu0 is not None:
            g = g - float(b1) * mu0.double()
        g = g / float(np.float32(1 - b1))
        return ([float(v) for v in st["losses"]], self._leaves(g),
                self._leaves(st["after"]))

    def _step_numbers(self, st, quant):
        ref = self.reference(st)
        depth = int(self.config["build"]["depth"])
        p0 = (dict(unet.leaves(self.variables["params"])) if "p0" not in st
              else self._leaves(st["p0"]))
        keep = {"leaves": compare.moving_leaves(ref[1]), "p0": p0,
                "last_block": f"decoder_L{depth - 1}"}
        prog = self._program(st) if quant is None else self.reference(
            st, quant)
        numbers, where = compare.step_readings(prog, ref, keep)
        where.update({"losses_program": list(prog[0]),
                      "losses_reference": list(ref[0]),
                      "leaves_compared": len(keep["leaves"]),
                      "leaves": len(ref[1])})
        return numbers, where

    def _sampler_numbers(self):
        """The window's checked batches against the reference sampler."""
        made = self.win["sampler"]
        fields = [self._fields(m) for m in made]
        if len(made) < N_CHECKED or any(f is None for f in fields):
            return {}, {"sampler": "the hooks recorded no batch"}
        build, fit, tr = (self.config["build"], self.config["fit"],
                          self.traffic)
        subjects = {}
        for m in made:
            for ident in m["subjects"]:
                i = int(str(ident).lstrip("s"))
                if ident not in subjects:
                    vol, lab = self._subject(i)
                    scaled, fill = sampler.robust_scaled(vol)
                    subjects[ident] = (scaled, fill, lab, vol.shape)
                    del vol
        aug = fit["augmenters"][0]["kwargs"]
        geometry = {"span": fit["real_space_span"], "dim": build["dim"],
                    "real_box_dim": fit.get("real_box_dim"),
                    "affine": np.diag(tr["subject_spacing"])}
        batches = list(zip(made, self.win["batches"], fields))
        return compare.sampler_readings(batches, subjects, geometry,
                                        (self.aug_seeds[0], aug))

    def check(self, quant=None):
        """The checked steps' numbers against the reference's (`quant`:
        the reference in the program's place at that precision, the
        control): of each step number the worse of the set-up's first
        three steps and the window's; and the window's batches against
        the reference sampler."""
        start, start_where = self._step_numbers(self.start, quant)
        win, win_where = self._step_numbers(self.win, quant)
        numbers = {k: max(start[k], win[k]) for k in STEP_NUMBERS}
        samp, samp_where = self._sampler_numbers()
        numbers.update(samp)
        where = {"start": start, "window": win, **samp_where,
                 "start_where": start_where, "window_where": win_where}
        return numbers, where

    def close(self):
        if self.tmp is not None:
            shutil.rmtree(self.tmp, ignore_errors=True)
            self.tmp = None


# ------------------------------------------------------------------ faults
# Faults planted under the program for the tests that show a broken timed
# path comes out not correct (`Driver(plant=...)`): each takes the driver
# once the program is built and before its first use.
def half_batch(driver):
    """Half of the batch left out: each step trains on the first half of
    its batch, the loss the mean over those rows."""
    rec = driver.recorder
    inner = rec.step

    def half(x, y, w):
        k = x.shape[0] // 2
        return inner(x[:k], y[:k], w[:k])

    rec.step = half


def altered_labels(driver):
    """An answer altered where it is produced: the sampler hands each
    batch's labels one row on (row i gets the labels of row i - 1)."""
    seq = driver.sequence._seq
    inner = seq.prepare_batches

    def altered(batch_x, batch_y, batch_w):
        x, y, w = inner(batch_x, batch_y, batch_w)
        return x, y.roll(1, dims=0), w

    seq.prepare_batches = altered


def unchanged_state(driver):
    """A step that returns its state unchanged: the optimizer's update is
    skipped."""
    driver.trainer.optimizer.step = lambda: None


def skipped_elastic(driver):
    """The augmenter's deformation skipped: every batch leaves the
    augmenter unchanged, with the augmenter's weights and draws."""
    seq = driver.sequence._seq
    inner = seq.augment

    def skipped(batch_x, batch_y, batch_w, bg_values):
        _, _, w = inner(batch_x, batch_y, batch_w, bg_values)
        return batch_x, batch_y, w

    seq.augment = skipped


def shifted_planes(driver):
    """Planes or boxes sampled off their place: each one 1 mm along the
    first scanner axis (2D: the offset along the normal)."""
    seq = driver.sequence._seq
    inner = seq._pool_images

    def shifted(pool, params, a, b):
        if a.ndim == 3:  # 2D: bases (B, 3, 3), offsets (B,)
            return inner(pool, params, a, b + 1.0)
        return inner(pool, params, a + np.float32([1.0, 0, 0]), b)

    seq._pool_images = shifted


FAULTS = {"half_batch": half_batch, "altered_labels": altered_labels,
          "unchanged_state": unchanged_state,
          "skipped_elastic": skipped_elastic,
          "shifted_planes": shifted_planes}
