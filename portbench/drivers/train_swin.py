"""Driver of the Swin UNETR training cell: the training cells' driver
(`portbench/drivers/train.py`: `Trainer.fit` over `mp train`'s pooled box
sampler with the configuration's Elastic3D, the same window, the same
recorded stretches and the same numbers) for a model with no JAX twin.

What differs: the weights are made from the seed by the reference's
layout (`portbench/reference/swin_unetr.py:layout`) and handed to the
port's loader by torch name; the optimizer's packed vector is read back
by those names, in torch's layout; the check's reference steps are the
Swin reference's (DiceCE, AdamW); the FLOPs of a box are
`portbench/arith_swin.py`'s; and the records carry the build and the
batch for the attention's roofline. The window of a program that cannot
build the model (no SwinUNETR) never starts: set-up raises before it
makes any data.
"""

from __future__ import annotations

import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from portbench import arith_swin, traffic
from portbench.drivers import train
from portbench.harness import TracedWindow
from portbench.reference import compare
from portbench.reference import swin_unetr as swin_ref

N_CHECKED = train.N_CHECKED
# The least share of the compared labels that label_err divides by
LABEL_FLOOR = 1e-3
STEP_NUMBERS = train.STEP_NUMBERS + ("attn_grad_err",)


def make_weights(build, seed, device):
    """{name: float32 tensor} on `device` from the seed, in one draw of
    the layout's order: the qkv weights normal(0, 1 / fan_in), so that
    q k^T / sqrt(head_dim) of the normed tokens is of order 1 and the
    windows attend as a trained model's do (MONAI's init, 0.02, leaves
    every softmax near uniform, and the attention's gradients near
    round-off); the other linear weights and the relative-position
    tables normal(0, 0.02) clipped at two standard deviations, linear
    biases uniform in +-0.02, conv weights and biases uniform in +-1 /
    sqrt(fan_in) (torch's default), LayerNorm weight 1 and bias 0."""
    gen = traffic.generator(device, seed, "weights")
    out = {}
    for name, shape, kind in swin_ref.layout(build):
        if name.endswith("attn.qkv.weight"):
            v = torch.randn(shape, generator=gen, device=device) \
                / float(np.sqrt(shape[1]))
        elif kind in ("linear", "table"):
            v = (torch.randn(shape, generator=gen, device=device)
                 * 0.02).clamp(-0.04, 0.04)
        elif kind == "linear_bias":
            v = (torch.rand(shape, generator=gen, device=device) * 2 - 1) \
                * 0.02
        elif kind == "conv":
            wshape = shape if len(shape) > 1 else None
            if wshape is None:  # a bias: the fan-in of its weight
                wshape = out[name[:-len("bias")] + "weight"].shape
            bound = 1.0 / np.sqrt(wshape[1] * np.prod(wshape[2:]))
            v = (torch.rand(shape, generator=gen, device=device) * 2 - 1) \
                * float(bound)
        else:
            v = torch.full(shape, 1.0 if kind == "norm_weight" else 0.0,
                           device=device)
        out[name] = v
    return out


def _tree(named):
    """The nested tree of {dotted name: tensor} (a weight file's)."""
    tree = {}
    for name, v in named.items():
        node = tree
        *parents, leaf = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _key(name):
    return tuple(name.split("."))


class Driver(train.Driver):
    # ------------------------------------------------------------ set-up
    def setup(self):
        from multiplanarunet_tpu_torch.logging.loggers import ScreenLogger
        from multiplanarunet_tpu_torch.models import checkpoint
        from multiplanarunet_tpu_torch.models.model_init import build_model
        from multiplanarunet_tpu_torch.preprocessing.data_preparation_funcs \
            import PREPARATION_FUNCS
        from multiplanarunet_tpu_torch.train.trainer import Trainer

        self.quiet = ScreenLogger(False)
        build, fit = self.config["build"], self.config["fit"]
        # A program without the model fails here, before any data is made
        model = build_model(build, mixed_precision=fit["mixed_precision"],
                            logger=self.quiet)
        self.tmp = Path(tempfile.mkdtemp(prefix=f"portbench-{self.cell}-"))
        data, proj = self.tmp / "data", self.tmp / "project"
        proj.mkdir()
        self._write_subjects(data)
        hp = self._hparams(proj, data)
        np.random.seed(traffic.derive(self.seed, "numpy") % 2 ** 32)
        seq, _ = PREPARATION_FUNCS[build["model_class_name"]](
            hparams=hp, no_val=True, logger=self.quiet, base_path=str(proj),
            device=self.device)
        seq.seed()
        np.random.seed(traffic.derive(self.seed, "sampler") % 2 ** 32)
        self.sequence = train.TimedSequence(seq)

        self.weights = make_weights(build, self.seed, self.device)
        model.load_state_dict(checkpoint.unet_state_dict_from_jax(
            _tree(self.weights), {}, model))
        self.trainer = Trainer(model, logger=self.quiet, device=self.device)
        self.trainer.compile_model(
            optimizer=fit["optimizer"],
            optimizer_kwargs=fit.get("optimizer_kwargs"), loss=fit["loss"],
            metrics=fit.get("metrics"), loss_kwargs=fit.get("loss_kwargs"))
        opt = self.trainer.optimizer
        # The packed vector's layout, to read its leaves after release
        self.layout = [(_key(name), tuple(p.shape), off)
                       for (name, p), off in zip(model.named_parameters(),
                                                 opt.packed.offsets)]
        self.recorder = train.StepRecorder(self.trainer.train_step, self)
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
        except train.WindowClosed:
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
        build = self.config["build"]
        self.records.update({
            "attempted": steps, "failed": 0, "window_s": t_end - t0,
            "samples": steps * self.batch, "steps_per_epoch": per_epoch,
            "step_ms": step_ms, "between_ms": between_ms,
            "sampler_s": self.sequence.seconds[n_seq:],
            "forward_flops_per_sample": arith_swin.forward_flops(build),
            "swin": {"build": dict(build), "batch": self.batch},
            "trace": rec.tracer.summary() if rec.tracer else None})

    # ------------------------------------------------------------- check
    def _leaves(self, vector):
        """{name path: tensor} of a vector in the optimizer's packed
        layout (torch's layout throughout)."""
        return {path: vector[off:off + int(np.prod(shape))].view(shape)
                for path, shape, off in self.layout}

    def _named(self, vector):
        return {".".join(p): v.clone() for p, v in
                self._leaves(vector).items()}

    def _opt(self):
        ok = self.config["fit"]["optimizer_kwargs"]
        return (float(ok["lr"]), float(ok["beta_1"]), float(ok["beta_2"]),
                float(ok["epsilon"]), float(ok["weight_decay"]))

    def reference(self, st, quant=None):
        """The Swin reference's (losses, first gradient, parameters after)
        over a stretch's batches, from the seed's weights (the start) or
        from the state the window started with, keyed by name paths."""
        params, state = self.weights, None
        if "p0" in st:
            params = self._named(st["p0"])
            state = (self._named(st["mu0"]), self._named(st["nu0"]),
                     st["count0"])
        losses, grad, after = swin_ref.train_steps(
            params, st["batches"][:N_CHECKED], self._opt(), quant=quant,
            state=state)
        return (losses, {_key(n): g for n, g in grad.items()},
                {_key(n): v for n, v in after.items()})

    def _invariant(self):
        """Leaves whose gradient is nought but for round-off: with one
        input channel, encoder1's 1^3 conv3 scales the image by one number
        a channel, which its InstanceNorm (no affine) divides out again."""
        if int(self.config["build"]["n_channels"]) == 1:
            return {("encoder1", "conv3", "weight")}
        return set()

    def _step_numbers(self, st, quant):
        ref = self.reference(st)
        p0 = ({_key(n): v for n, v in self.weights.items()}
              if "p0" not in st else self._leaves(st["p0"]))
        leaves = [p for p in compare.moving_leaves(ref[1])
                  if p not in self._invariant()]
        keep = {"leaves": leaves, "p0": p0, "last_block": None}
        prog = self._program(st) if quant is None else self.reference(
            st, quant)
        numbers, where = compare.step_readings(prog, ref, keep)
        # The windowed attention's leaves (qkv, projection, relative
        # table): a dropped shift mask moves their gradient and hardly
        # any other number
        attn = [p for p in leaves if "attn" in p]
        numbers["attn_grad_err"] = compare.total_error(prog[1], ref[1], attn)
        where.update({"losses_program": list(prog[0]),
                      "losses_reference": list(ref[0]),
                      "leaves_compared": len(leaves),
                      "leaves": len(ref[1])})
        return numbers, where

    def check(self, quant=None):
        """The training cells' check (`train.Driver.check`), with the
        windowed attention's gradient error `attn_grad_err` among the step
        numbers (the worse of the two stretches)."""
        start, start_where = self._step_numbers(self.start, quant)
        win, win_where = self._step_numbers(self.win, quant)
        numbers = {k: max(start[k], win[k]) for k in STEP_NUMBERS}
        samp, samp_where = self._sampler_numbers()
        numbers.update(samp)
        where = {"start": start, "window": win, **samp_where,
                 "start_where": start_where, "window_where": win_where}
        return numbers, where

    def _sampler_numbers(self):
        """The training cells' sampler numbers, with `label_err` over at
        least LABEL_FLOOR of the labels compared: here 1.5 mm samples
        read 0.78 x 0.78 x 3.0 mm voxels, and about 6e-6 of the nearest
        reads fall within float32 round-off of a tie between two voxels
        (the program places its samples in float32, the reference in
        float64); a stretch whose samples the augmenter all leaves
        undeformed would divide those by 1."""
        numbers, where = super()._sampler_numbers()
        if "label_err" in numbers:
            compared = sum(int(np.prod(y.shape)) for _, y, _ in
                           self.win["batches"][:N_CHECKED])
            numbers["label_err"] = where["labels_differ"] / max(
                where["labels_changed"], LABEL_FLOOR * compared, 1.0)
            where["labels_compared"] = compared
        return numbers, where


# ------------------------------------------------------------------ faults
# The training cells' faults, and one of the model's own: the shifted
# blocks attend without their shift mask.
def dropped_shift_mask(driver):
    """Each shifted block attends across the regions of its shifted grid:
    the stages' shift masks are dropped (all zero)."""
    for stage in driver.trainer.model.swinViT.stages:
        inner = stage.plan

        def plan(grid, device, inner=inner):
            ws, ss, padded, mask = inner(grid, device)
            return ws, ss, padded, None if mask is None else mask * 0.0

        stage.plan = plan


FAULTS = dict(train.FAULTS, dropped_shift_mask=dropped_shift_mask)
