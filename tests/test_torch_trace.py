"""The port's span recorder (`utils/trace.py`) on the CPU: off, it is a
shared no-op that reads no clock; on, `predict_image` and `Trainer.fit`
give their spans with the right parents and request ids (the sampler's
in the prefetch worker); the planner's candidate counter; the spans in a
torch.profiler trace; a span closed by an exception; the Profiler
callback's lines; and many threads recording at once."""
import sys
import threading

import numpy as np
import pytest
import torch
from torch import nn

from multiplanarunet_tpu_torch.bin.toy_data import create_dataset
from multiplanarunet_tpu_torch.callbacks import callbacks as tcb
from multiplanarunet_tpu_torch.image.image_pair_loader import ImagePairLoader
from multiplanarunet_tpu_torch.image.queue.queues import EagerQueue
from multiplanarunet_tpu_torch.image.volume_sampler import VolumeSampler
from multiplanarunet_tpu_torch.logging.loggers import ScreenLogger
from multiplanarunet_tpu_torch.models.unet import UNet, glorot_init
from multiplanarunet_tpu_torch.ops import geometry, shear_plan
from multiplanarunet_tpu_torch.sequences import get_sequence
from multiplanarunet_tpu_torch.train.trainer import Trainer
from multiplanarunet_tpu_torch.utils import trace
from multiplanarunet_tpu_torch.utils.fusion.fuse_and_predict import (
    MultiViewPredictor,
)
from tests.torch_projects import torch_threads  # noqa: F401


N_VIEWS = 3
EPOCHS, STEPS = 2, 3
SAMPLER = ("sampler.draw", "sampler.labels", "sampler.walk",
           "sampler.images", "sampler.augment")


@pytest.fixture(autouse=True)
def clean_recorder():
    """Each test starts and ends with the recorder off and empty."""
    trace.disable()
    trace.take()
    yield
    trace.disable()
    trace.take()


class OneHot(nn.Module):
    """One-hot of the rounded intensity: a model with no weights."""

    n_classes = 3

    def forward(self, x):
        cls = torch.clamp(torch.round(x[:, 0].float()), 0, 2)
        return nn.functional.one_hot(cls.long(), 3).permute(0, 3, 1, 2) \
            .float()


class _Image:
    def __init__(self, volume, affine):
        self.shape = volume.shape
        self.affine = affine
        self.interpolator = VolumeSampler(volume, affine)


def _predict(n_images=2):
    """predict_image over n_images small volumes, shear resampler."""
    rng = np.random.RandomState(3)
    pred = MultiViewPredictor(OneHot(), sample_dim=16, real_space_span=15.0,
                              n_classes=3, device="cpu", chunk=4,
                              resampler="shear")
    views = geometry.sample_random_views_with_angle_restriction(
        N_VIEWS, 60, rng=rng)
    for _ in range(n_images):
        vol = rng.randint(0, 3, (16, 16, 16, 1)).astype(np.float32)
        pred.predict_image(_Image(vol, np.eye(4)), views, n_planes="same+2",
                           return_per_view=False)
    return pred


@pytest.fixture(scope="module")
def train_seq(tmp_path_factory):
    """The pooled 2D sampler with Elastic2D over 2 toy images of 16^3."""
    root = tmp_path_factory.mktemp("trace_toy")
    create_dataset(root / "train", 2, 16, 1, np.random.RandomState(7),
                   "train")
    loader = ImagePairLoader(base_dir=root / "train",
                             logger=ScreenLogger(False), no_log=True)
    loader.set_scaler_and_bg_values(bg_value="1pct", scaler="RobustScaler")
    views = geometry.sample_random_views_with_angle_restriction(
        3, 60, rng=np.random.RandomState(2))
    augmenters = [{"cls_name": "Elastic2D",
                   "kwargs": {"alpha": [0, 100], "sigma": [10, 12],
                              "apply_prob": 0.5, "seed": 5}}]
    seq = get_sequence(EagerQueue(loader, logger=ScreenLogger(False)),
                       logger=ScreenLogger(False), device="cpu",
                       intrp_style="iso_live", views=views, dim=16,
                       batch_size=2, n_classes=4, real_space_span=17.0,
                       noise_sd=0.1, fg_batch_fraction=0.5, no_log=True,
                       list_of_augmenters=augmenters)
    return seq


def _trainer():
    model = glorot_init(UNet(n_classes=4, n_channels=1, depth=2,
                             init_filters=4), seed=0, device="cpu")
    return Trainer(model, logger=ScreenLogger(False),
                   device="cpu").compile_model(
        "Adam", {"lr": 1e-3}, "SparseCategoricalCrossentropy",
        ["sparse_categorical_accuracy"])


def _fit(seq, trainer=None, callbacks=()):
    trainer = trainer or _trainer()
    trainer.fit(seq, None, batch_size=2, n_epochs=EPOCHS,
                train_im_per_epoch=2 * STEPS, callbacks=list(callbacks),
                no_im=True, verbose=False)
    return trainer


def _by_name(records):
    out = {}
    for r in records["spans"]:
        out.setdefault(r["name"], []).append(r)
    return out


# ------------------------------------------------------------------ off
def test_off_span_is_the_shared_noop_and_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("the clock was read")

    monkeypatch.setattr(trace.time, "perf_counter_ns", no_clock)
    s = trace.span("predict.plan", device="cpu", request=1)
    assert s is trace.NO_SPAN
    assert trace.span("train.step") is s
    with s as inner:
        inner.count("x")
    trace.count("shear_plan.candidates", 5)
    assert trace.take() == {"spans": [], "counters": {}}


def test_off_predict_and_fit_leave_no_records(train_seq):
    _predict()
    _fit(train_seq)
    assert trace.take() == {"spans": [], "counters": {}}


# ------------------------------------------------------------------- on
def test_predict_spans_parents_and_requests():
    trace.enable()
    _predict(n_images=2)
    records = trace.take()
    by = _by_name(records)
    roots = by["predict.image"]
    assert [r["request"] for r in roots] == [1, 2]
    assert all(r["parent"] is None for r in roots)
    ids = {r["id"]: r["request"] for r in roots}
    counts = {"predict.plan": 1, "predict.stage": 1, "predict.stack": N_VIEWS,
              "predict.unet": N_VIEWS, "predict.remap": N_VIEWS,
              "predict.fuse": 1}
    for name, n in counts.items():
        assert len(by[name]) == 2 * n, name
        for r in by[name]:
            assert r["parent"] in ids and r["request"] == ids[r["parent"]]
            assert r["end_ns"] >= r["start_ns"] and r["host_ms"] >= 0
            assert r["device_ms"] is None  # no card
    # every candidate was counted inside a planning span
    plan_counts = sum(r["counters"]["shear_plan.candidates"]
                      for r in by["predict.plan"])
    assert plan_counts == records["counters"]["shear_plan.candidates"] > 0
    assert trace.take() == {"spans": [], "counters": {}}


def test_fit_spans_parents_and_requests(train_seq):
    trace.enable()
    _fit(train_seq)
    by = _by_name(trace.take())
    epochs = by["train.epoch"]
    assert [r["request"] for r in epochs] == [(e, None) for e in
                                              range(EPOCHS)]
    assert all(r["parent"] is None for r in epochs)
    epoch_of = {r["id"]: r["request"][0] for r in epochs}
    main = threading.current_thread().name
    for name, n in (("train.step", STEPS), ("train.batch_wait", STEPS),
                    ("train.epoch_end", 1)):
        assert len(by[name]) == EPOCHS * n, name
        for r in by[name]:
            assert r["thread"] == main
            assert epoch_of[r["parent"]] == r["request"][0]
    assert [r["request"] for r in by["train.step"]] == [
        (e, s) for e in range(EPOCHS) for s in range(STEPS)]
    # the allocator counter is read on the card only
    assert all("alloc.cuda_mallocs" not in r["counters"] for r in epochs)


def test_worker_sample_spans_carry_their_batch(train_seq):
    trace.enable()
    _fit(train_seq)
    by = _by_name(trace.take())
    main = threading.current_thread().name
    samples = by["train.sample"]
    assert sorted(r["request"] for r in samples) == [
        (e, i) for e in range(EPOCHS) for i in range(STEPS)]
    assert all(r["parent"] is None and r["thread"] != main
               for r in samples)
    sample_ids = {r["id"]: r["request"] for r in samples}
    draw_ids = {r["id"] for r in by["sampler.draw"]}
    for name in SAMPLER:
        assert len(by[name]) >= EPOCHS * STEPS, name
        for r in by[name]:
            # sampler.labels' depth-0 gather sits inside sampler.draw
            parent = r["parent"]
            assert parent in sample_ids or (
                name == "sampler.labels" and parent in draw_ids)
    for r in by["sampler.augment"]:
        assert r["request"] == sample_ids[r["parent"]]


def test_plan_candidates_equal_finish_plan_calls(monkeypatch):
    calls = []
    inner = shear_plan._finish_plan

    def counted(*args, **kwargs):
        calls.append(1)
        return inner(*args, **kwargs)

    monkeypatch.setattr(shear_plan, "_finish_plan", counted)
    trace.enable()
    _predict(n_images=2)
    records = trace.take()
    assert records["counters"]["shear_plan.candidates"] == len(calls) > 0
    # a stack and a remap plan a view, up to 36 candidates each
    per_image = len(calls) / 2
    assert per_image <= 36 * 2 * N_VIEWS


def test_plan_candidates_and_pruned_cover_every_factoring_pair(
        monkeypatch):
    """One predict_image: the finished candidates and the pruned ones
    together are every (out_perm, perm) pair that factors over the
    volume's plans (a stack and a remap plan a view), all counted inside
    the planning span."""
    factored = []
    inner = shear_plan._peel

    def peel(Np):
        ops, ok = inner(Np)
        factored.append(ok)
        return ops, ok

    monkeypatch.setattr(shear_plan, "_peel", peel)
    trace.enable()
    _predict(n_images=1)
    records = trace.take()
    assert len(factored) == 36 * 2 * N_VIEWS
    plan, = _by_name(records)["predict.plan"]
    totals = records["counters"]
    for name in ("shear_plan.candidates", "shear_plan.pruned"):
        assert plan["counters"][name] == totals[name]
    assert totals["shear_plan.pruned"] > 0
    assert (totals["shear_plan.candidates"] + totals["shear_plan.pruned"]
            == sum(factored))


def test_profiler_shows_the_spans(train_seq):
    # Profile every thread, so that the prefetch worker's spans show too
    cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            experimental_config=cfg) as prof:
        _predict(n_images=1)
        _fit(train_seq)
    names = {e.name for e in prof.events()}
    for name in ("mp.predict.plan", "mp.predict.image", "mp.train.step",
                 "mp.train.batch_wait", "mp.train.sample"):
        assert name in names, name


def test_profiled_stretch_is_recorded_with_the_recorder_off(train_seq):
    """Under a profiler of the calling thread alone the spans are
    recorded as if the recorder were on, the prefetch worker's too."""
    assert not trace.enabled()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _predict(n_images=1)
        _fit(train_seq)
    by = _by_name(trace.take())
    assert len(by["predict.plan"]) == 1
    assert len(by["train.step"]) == EPOCHS * STEPS
    assert len(by["train.sample"]) == EPOCHS * STEPS
    assert len(by["sampler.augment"]) == EPOCHS * STEPS
    # once the profiler has stopped, nothing more is recorded
    _predict(n_images=1)
    assert trace.take() == {"spans": [], "counters": {}}


class WindowClosed(Exception):
    pass


def test_exception_closes_its_span():
    trace.enable()
    with pytest.raises(WindowClosed):
        with trace.span("outer"):
            with trace.span("train.step", request=(0, 0)):
                raise WindowClosed
    by = _by_name(trace.take())
    step, outer = by["train.step"][0], by["outer"][0]
    assert step["parent"] == outer["id"] and step["end_ns"] is not None
    assert trace.RECORDER._stack() == []


def test_exception_from_train_step_closes_the_fit_spans(train_seq):
    trainer = _trainer()
    step = trainer.train_step
    calls = []

    def closing(X, y, w):
        calls.append(1)
        if len(calls) == STEPS + 2:
            raise WindowClosed
        return step(X, y, w)

    trainer.train_step = closing
    trace.enable()
    with pytest.raises(WindowClosed):
        _fit(train_seq, trainer)
    by = _by_name(trace.take())
    assert len(by["train.step"]) == STEPS + 2
    assert [r["request"] for r in by["train.epoch"]] == [(0, None),
                                                        (1, None)]
    assert trace.RECORDER._stack() == []


def test_profiler_callback_logs_one_line_per_span(train_seq):
    class Log:
        def __init__(self):
            self.lines = []

        def __call__(self, msg, *args, **kwargs):
            self.lines.append(str(msg))

    trainer = _trainer()
    trainer.logger = Log()
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        cb = tcb.Profiler(log_dir=tmp, epochs=(1,))
        _fit(train_seq, trainer, callbacks=[cb])
    lines = [l for l in trainer.logger.lines if l.startswith("[Profiler]")]
    assert any("trace written" in l for l in lines)
    spans = {l.split()[2].rstrip(":"): l for l in lines
             if l.startswith("[Profiler] span ")}
    assert spans["train.step:".rstrip(":")].split()[3] == str(STEPS)
    assert "train.sample" in spans and "train.batch_wait" in spans
    assert "device - ms" in spans["train.step"]  # no card
    # the callback leaves the recorder off, as it found it
    assert not trace.enabled()


def test_many_threads_record_every_span_and_count():
    n_threads, n_spans = 16, 200
    trace.enable()
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(n_spans):
                with trace.span("outer", request=(k, i)):
                    with trace.span("inner"):
                        trace.count("c")
                        trace.count("d", 2)

        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(before)
    records = trace.take()
    by = _by_name(records)
    assert len(by["outer"]) == len(by["inner"]) == n_threads * n_spans
    assert records["counters"] == {"c": n_threads * n_spans,
                                   "d": 2 * n_threads * n_spans}
    outer = {r["id"]: r for r in by["outer"]}
    for r in by["inner"]:
        parent = outer[r["parent"]]
        assert r["request"] == parent["request"]
        assert r["thread"] == parent["thread"]
        assert r["counters"] == {"c": 1, "d": 2}


def test_summary_sums_per_name():
    records = {"spans": [
        {"name": "a", "host_ms": 1.0, "device_ms": None},
        {"name": "b", "host_ms": 2.0, "device_ms": 3.0},
        {"name": "a", "host_ms": 0.5, "device_ms": None},
        {"name": "b", "host_ms": 1.0, "device_ms": 1.5}], "counters": {}}
    assert trace.summary(records) == {"a": (2, 1.5, None),
                                      "b": (2, 3.0, 4.5)}
