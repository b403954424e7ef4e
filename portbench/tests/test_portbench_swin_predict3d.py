"""The 3D predict and Swin UNETR cells on the CPU: their drivers' faults
at the tiny size come out not correct where the same seed's sound run is
correct (every fault of the 3D predict driver; the Swin driver's own,
the dropped shift mask: its others are the training cells' and are read
on the card by `test_portbench_faults.py`), the fp8 control of the 3D
predict cell is not correct, the frozen Swin FLOP count against a count
of the reference's operations, and the readers of the cells' new spans
and counters on synthetic records and on a tiny traced run."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import arith_swin, harness, run
from portbench.reference import swin_unetr as swin_ref
from portbench.tests.tiny import write_tiny

SEED = 2 ** 40 + 17
PREDICT3D, SWIN = "predict3d-256", "train3d-swinunetr-96-b4"


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return write_tiny(tmp_path_factory.mktemp("tiny_new_cells"))


def _run(tiny, cell, plant=None, control=None, trace=0):
    bench_path, data = tiny
    code, result = run.main(
        ["--workload", cell, "--seed", str(SEED), "--seconds", "0.3",
         "--trace", str(trace)], bench_path=bench_path, data_dir=data,
        device="cpu", require_card=False, plant=plant, control=control)
    assert code == 0
    return result


@pytest.mark.parametrize("fault", sorted(
    harness.driver_module("predict3d").FAULTS))
def test_tiny_predict3d_fault_is_not_correct(tiny, fault):
    plant = harness.driver_module("predict3d", tiny[1]).FAULTS[fault]
    result = _run(tiny, PREDICT3D, plant=plant)
    assert result["correct"] is False, result["compared"]


def test_tiny_predict3d_sound_and_control(tiny):
    assert _run(tiny, PREDICT3D)["correct"] is True
    control = _run(tiny, PREDICT3D, control="fp8")
    assert control["correct"] is False, control["compared"]


# The attention's gradient error of a sound run at the tiny size: 0.13
# on the CPU (the cell's own size on the card: 0.045-0.129, limit 0.19);
# the dropped mask reads 0.70 and the fp8 control 0.48 there
TINY_ATTN_GRAD_ERR = 0.26


@pytest.fixture(scope="module")
def tiny_swin(tmp_path_factory):
    """The tiny copies, the Swin cell's subjects at 4.5 mm: a tiny box
    (32 samples over 144 mm) then lies across their structure, where at
    the cell's own spacing it would read mostly the fill around them, and
    attention over uniform tokens cannot tell a mask; `attn_grad_err`'s
    limit is the tiny size's."""
    bench_path, data = write_tiny(tmp_path_factory.mktemp("tiny_swin"))
    path = data / "workloads" / f"{SWIN}.json"
    workload = harness.load_json(path)
    workload["traffic"]["subject_spacing"] = [4.5, 4.5, 4.5]
    workload["limits"]["attn_grad_err"] = TINY_ATTN_GRAD_ERR
    path.write_text(json.dumps(workload))
    return bench_path, data


def test_tiny_swin_dropped_shift_mask_is_not_correct(tiny_swin):
    assert _run(tiny_swin, SWIN)["correct"] is True
    plant = harness.driver_module("train_swin", tiny_swin[1]).FAULTS[
        "dropped_shift_mask"]
    result = _run(tiny_swin, SWIN, plant=plant)
    assert result["correct"] is False, result["compared"]


def _build(dim, feature_size, n_classes=3):
    return {"model_class_name": "SwinUNETR", "dim": dim,
            "feature_size": feature_size, "patch_size": 2,
            "window_size": 7, "depths": [2, 2, 2, 2],
            "num_heads": [3, 6, 12, 24], "n_channels": 1,
            "n_classes": n_classes}


def _counted(build, device):
    with torch.device(device):
        params = {name: torch.zeros(shape) for name, shape, _ in
                  swin_ref.layout(build)}
        x = torch.zeros((1, 1) + (int(build["dim"]),) * 3)
    with FlopCounterMode(display=False) as fc:
        swin_ref.forward(params, x)
    return fc.get_total_flops()


@pytest.mark.parametrize("dim,feature_size", [(32, 12), (64, 12)])
def test_swin_flops_small(dim, feature_size):
    build = _build(dim, feature_size)
    assert _counted(build, "cpu") == arith_swin.forward_flops(build)


def test_swin_flops_configuration():
    build = harness.load_json(harness.HERE / "configs"
                              / "swinunetr-btcv-f48.json")["build"]
    flops = arith_swin.forward_flops(build)
    assert round(flops / 1e9, 1) == 637.0
    assert _counted(build, "meta") == flops


def test_swin_attention_work():
    """At 96^3, F 48: stage 1 pads 48^3 to 49^3 (343 windows of 343
    tokens), stage 2 24^3 to 28^3 (64), stage 3 12^3 to 14^3 (8), stage 4
    attends over its 6^3 grid in one window, unshifted."""
    build = _build(96, 48, 14)
    n_bytes, flops, window_heads = arith_swin.attention_work(build, 4)
    assert window_heads == 2 * 4 * (343 * 3 + 64 * 6 + 8 * 12 + 1 * 24)
    qk_pv = 2 * 4 * sum(n * h * 4 * N * N * 16 for n, h, N in
                        ((343, 3, 343), (64, 6, 343), (8, 12, 343),
                         (1, 24, 216)))
    assert flops == qk_pv
    assert n_bytes > 0
    # twice the forwards, twice the least time
    one = arith_swin.attention_least_seconds(build, 4, window_heads)
    two = arith_swin.attention_least_seconds(build, 4, 2 * window_heads)
    assert two == pytest.approx(2 * one)


# ------------------------------------------------------------ span readers
def _reader(name):
    return harness.load_file_module(
        harness.HERE / "metrics" / f"{name}.py", f"portbench_metric_{name}")


def _span(name, request, device_ms=None, counters=None):
    return {"id": 0, "name": name, "parent": None, "thread": "t",
            "request": request, "start_ns": 0, "end_ns": 1, "host_ms": 1.0,
            "device_ms": device_ms, "counters": counters or {}}


def _predict3d_records():
    spans = []
    for vol in (1, 2):
        for chunk in range(12):
            spans += [_span("predict3d.gather", vol, 1.0 + vol),
                      _span("predict3d.unet", vol, 30.0,
                            {"predict3d.boxes": 16}),
                      _span("predict3d.scatter", vol, 2.0)]
    return {"kind": "predict", "boxes_per_volume": 192.0,
            "program_spans": {"spans": spans, "counters": {}}}


def _swin_records(build, batch):
    _, _, per_forward = arith_swin.attention_work(build, batch)
    spans = []
    for step in ((0, 5), (0, 6)):
        spans.append(_span("swin.encoder", step, 40.0))
        for block in range(8):
            spans.append(_span("swin.attn", step, 2.5, {
                "swin.windows": per_forward / 8}))
        spans.append(_span("swin.decoder", step, 100.0))
    return {"kind": "train", "swin": {"build": build, "batch": batch},
            "program_spans": {"spans": spans, "counters": {}}}


def test_predict3d_readers():
    rec = _predict3d_records()
    assert _reader("predict3d.gather_ms").read(rec) == pytest.approx(30.0)
    assert _reader("predict3d.unet_ms").read(rec) == pytest.approx(360.0)
    assert _reader("predict3d.scatter_ms").read(rec) == pytest.approx(24.0)
    assert _reader("predict3d.boxes").read(rec) == 192.0
    for name in ("predict3d.gather_ms", "predict3d.unet_ms",
                 "predict3d.scatter_ms", "predict3d.boxes"):
        assert _reader(name).read({"kind": "predict",
                                   "program_spans": None}) is None
        assert _reader(name).read(dict(rec, kind="train")) is None


def test_swin_readers():
    build = _build(96, 48, 14)
    rec = _swin_records(build, 4)
    assert _reader("train.swin_encoder_ms").read(rec) == pytest.approx(40.0)
    assert _reader("train.swin_attn_ms").read(rec) == pytest.approx(20.0)
    assert _reader("train.swin_decoder_ms").read(rec) == pytest.approx(
        100.0)
    least = arith_swin.attention_least_seconds(
        build, 4, arith_swin.attention_work(build, 4)[2])
    # one forward's least time over the mean step's 20 ms
    assert _reader("swin.attn_roofline_pct").read(rec) == pytest.approx(
        100.0 * least / 0.020)
    cpu = _swin_records(build, 4)
    for s in cpu["program_spans"]["spans"]:
        s["device_ms"] = None
    for name in ("train.swin_encoder_ms", "train.swin_attn_ms",
                 "train.swin_decoder_ms", "swin.attn_roofline_pct"):
        assert _reader(name).read(cpu) is None  # off the card
        assert _reader(name).read({"kind": "train",
                                   "program_spans": None}) is None


def test_swin_forward_records_its_spans():
    """A traced forward of the tiny model holds the encoder, decoder and
    eight attention spans, and counts the windows x heads that
    `arith_swin` counts for it."""
    from multiplanarunet_tpu_torch.models.swin_unetr import SwinUNETR
    from multiplanarunet_tpu_torch.utils import trace

    model = SwinUNETR(3, 1, feature_size=12)
    trace.take()
    trace.enable()
    try:
        with torch.no_grad():
            model(torch.zeros(2, 1, 32, 32, 32))
    finally:
        trace.disable()
        records = trace.take()
    names = [r["name"] for r in records["spans"]]
    assert names.count("swin.attn") == 8
    assert names.count("swin.encoder") == names.count("swin.decoder") == 1
    assert records["counters"]["swin.windows"] == \
        arith_swin.attention_work(_build(32, 12), 2)[2]


def test_tiny_traced_predict3d_counts_its_boxes(tiny):
    """With the recorder on, a tiny run reports the boxes a volume: 7^3
    of the tiling (a 25^3 volume at 4 mm in 16 mm boxes) and twice as
    many random ones."""
    from multiplanarunet_tpu_torch.utils import trace

    trace.take()
    trace.enable()
    try:
        result = _run(tiny, PREDICT3D, trace=1)
    finally:
        trace.disable()
        trace.take()
    assert result["metrics"]["predict3d.boxes"]["value"] == 3 * 7 ** 3
    assert result["metrics"]["mfu.predict3d"]["value"] > 0
