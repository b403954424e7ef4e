"""The U-Net's conv epilogue (`ops/unet_epilogue.py`, `models/unet.py:
conv_epilogue`) on the CPU: the plain version against the ops it stands
for, bit for bit; the eval forward of UNet (its forms, ReLU and ELU),
UNet3D and MultiTaskUNet2D with grad mode off, which runs the epilogue,
against the same model's forward with grad mode on, which runs the ops
one by one; the predictor's plane chunks kept channels-last through
every conv of its twin; train mode and grad mode never call it; the
launch counters read 0 on the CPU; and the benchmark's readers of the
trace counters.

Tolerances: float32 1e-6 relative (the bias is added after the conv's
sum rather than inside it); bf16 one bf16 ulp of the probabilities' unit
range (2^-7): the CPU's bf16 conv adds the bias inside its float32 sum,
so each conv of the grad-mode forward may round one ulp away from the
conv-then-add that cuDNN and the epilogue compute, and that carries to
the probabilities."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from portbench import harness
from multiplanarunet_tpu_torch.models import unet as unet_module
from multiplanarunet_tpu_torch.models.multitask_unet import MultiTaskUNet2D
from multiplanarunet_tpu_torch.models.unet import (
    BATCH_NORM,
    CONV,
    UNet,
    glorot_init,
)
from multiplanarunet_tpu_torch.models.unet3d import UNet3D
from multiplanarunet_tpu_torch.ops import unet_epilogue as epilogue
from multiplanarunet_tpu_torch.utils import trace
from multiplanarunet_tpu_torch.utils.fusion.fuse_and_predict import (
    MultiViewPredictor,
)
from tests.torch_projects import torch_threads  # noqa: F401


F32_RTOL, BF16_ATOL = 1e-6, 2.0 ** -7
KW = dict(n_classes=3, n_channels=2, depth=2, complexity_factor=2.0,
          init_filters=8)


def _randomize(model, seed):
    """glorot weights, random biases and BatchNorm parameters and
    statistics (positive variances and scales)."""
    glorot_init(model, seed, device="cpu")
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for key, t in model.state_dict().items():
            if t.dim() == 1 and t.is_floating_point():
                draw = (0.5 + rng.rand(*t.shape)
                        if key.endswith(("running_var", "bn.weight",
                                         "bn_up.weight"))
                        else 0.1 * rng.randn(*t.shape))
                t.copy_(torch.from_numpy(draw.astype(np.float32)))
    return model


def _bn(channels, ndim, seed):
    bn = BATCH_NORM[ndim](channels)
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(
            rng.randn(channels).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(
            (0.5 + rng.rand(channels)).astype(np.float32)))
        bn.weight.copy_(torch.from_numpy(
            (0.5 + rng.rand(channels)).astype(np.float32)))
        bn.bias.copy_(torch.from_numpy(
            rng.randn(channels).astype(np.float32)))
    return bn.eval()


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
@pytest.mark.parametrize("with_bn", [True, False], ids=["bn", "no_bn"])
@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_plain_epilogue_equals_the_ops(dtype, ndim, with_bn, relu):
    """The bias-free conv output through the plain version (and the
    wrapper, which runs it on the CPU) against conv-then-add, the
    activation and the eval BatchNorm module, bit for bit."""
    torch.manual_seed(ndim)
    conv = CONV[ndim](4, 6, 3, padding="same")
    x = torch.randn(3, 4, *(7, 9, 5)[:ndim], dtype=dtype)
    y = conv(x, False)
    bn = _bn(6, ndim, 7) if with_bn else None
    act = F.relu if relu else unet_module.get_activation("linear")
    want = act(y + conv.bias.to(dtype).view((1, -1) + (1,) * ndim))
    if bn is not None:
        want = bn(want)
    stats = None if bn is None else (bn.running_mean, bn.running_var,
                                     bn.weight, bn.bias, bn.eps)
    for fn in (epilogue.unet_epilogue_reference, epilogue.unet_epilogue):
        got = fn(y, conv.bias, relu, stats)
        assert got.dtype == dtype
        assert torch.equal(got, want)


def _unet(seed, dtype, **fields):
    return _randomize(UNet(**KW, dtype=dtype, **fields), seed)


def _unet3d(seed, dtype, **fields):
    return _randomize(UNet3D(3, 2, depth=2, init_filters=8, dtype=dtype,
                             **fields), seed)


def _multitask(seed, dtype):
    return _randomize(MultiTaskUNet2D(["a", "b"], [3, 4], [2, 2], depth=2,
                                      complexity_factor=2.0, init_filters=8,
                                      dtype=dtype), seed)


# (model constructor, input shapes, conv sites a forward runs through the
# epilogue): depth 2 is 2 * 2 encoder + 2 bottom + 3 * 2 decoder convs;
# the multi-task model runs its encoder once per task
MODELS = {
    "unet": (lambda s, d: _unet(s, d), [(2, 2, 30, 30)], 12),
    "unet-dilated-pad8": (lambda s, d: _unet(s, d, dilated_upconv=True,
                                             lane_pad=8),
                          [(2, 2, 30, 30)], 12),
    "unet-subpixel": (lambda s, d: _unet(s, d, subpixel_decoder=True),
                      [(2, 2, 30, 30)], 12),
    "unet-fused-bn": (lambda s, d: _unet(s, d, predict_fused_bn=True),
                      [(2, 2, 30, 30)], 12),
    "unet-skip-bn": (lambda s, d: _unet(s, d, predict_skip_bn=True),
                     [(2, 2, 30, 30)], 12),
    "unet-elu": (lambda s, d: _unet(s, d, activation="elu"),
                 [(2, 2, 30, 30)], 0),
    "unet3d": (lambda s, d: _unet3d(s, d), [(1, 2, 12, 14, 12)], 12),
    "unet3d-dilated": (lambda s, d: _unet3d(s, d, dilated_upconv=True),
                       [(1, 2, 12, 14, 12)], 12),
    "multitask": (_multitask, [(2, 2, 16, 16), (1, 2, 20, 20)],
                  2 * (2 * 2) + 2 * (2 + 3 * 2)),
}


def _inputs(shapes, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(*s, generator=g) for s in shapes]


def _forward(model, xs):
    if isinstance(model, MultiTaskUNet2D):
        return model(xs)
    return [model(xs[0])]


@pytest.fixture
def spy(monkeypatch):
    """Records the epilogue's calls from the U-Net's blocks: whether each
    conv output is NCHW-contiguous (and that the kernel takes its layout:
    `row_length` raises on any other)."""
    calls = []
    real = unet_module.unet_epilogue

    def counted(*args, **kwargs):
        epilogue.row_length(args[0])
        calls.append(args[0].is_contiguous())
        return real(*args, **kwargs)

    monkeypatch.setattr(unet_module, "unet_epilogue", counted)
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_eval_forward_matches_the_grad_mode_forward(spy, name, dtype):
    build, shapes, sites = MODELS[name]
    model = build(3, dtype)
    model.eval()
    xs = _inputs(shapes, 5)
    want = _forward(model, xs)  # grad mode on: the ops one by one
    assert not spy
    with torch.inference_mode():
        got = _forward(model, xs)
    assert len(spy) == sites
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if dtype == torch.float32:
            torch.testing.assert_close(g, w.detach(), rtol=F32_RTOL, atol=0)
        else:
            assert (g - w.detach()).abs().max().item() <= BF16_ATOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["unet", "unet3d", "multitask"])
def test_channels_last_outputs_run_the_ops(spy, name, dtype):
    """Inputs made from channels-last data, as the Trainer's validation
    feeds them: a conv that answers in channels-last goes through the
    epilogue like any other (on the card the kernel takes that layout; on
    the CPU the plain version runs the ops)."""
    build, shapes, sites = MODELS[name]
    model = build(3, dtype).eval()
    xs = [x.movedim(1, -1).contiguous().movedim(-1, 1)
          for x in _inputs(shapes, 5)]
    want = _forward(model, xs)
    with torch.inference_mode():
        got = _forward(model, xs)
    assert len(spy) == sites
    # The CPU's 2D convs answer such inputs in channels-last (its 3D ones
    # in either order, by dtype)
    assert name == "unet3d" or not all(spy)
    for g, w in zip(got, want):
        if dtype == torch.float32:
            torch.testing.assert_close(g, w.detach(), rtol=F32_RTOL, atol=0)
        else:
            assert (g - w.detach()).abs().max().item() <= BF16_ATOL


def _channels_last(t):
    """Dense in channels-last order, the channel stride 1 (so a C = 1
    tensor dense in NCHW order does not pass)."""
    return t.stride(1) == 1 and t.movedim(1, -1).is_contiguous()


@pytest.mark.parametrize("n_channels", [1, 3])
def test_predictor_feeds_its_chunks_channels_last(spy, n_channels):
    """`MultiViewPredictor._unet_stack` hands its twin (dilated up-convs,
    lane_pad 8) each plane chunk in channels-last order: every conv and
    up-conv takes and gives that layout, every epilogue gets a
    channels-last output, and the probabilities equal the twin's forward
    on the same chunks in NCHW order."""
    model = _randomize(UNet(3, n_channels, depth=2, complexity_factor=2.0,
                            init_filters=8), 7).eval()
    predictor = MultiViewPredictor(model, sample_dim=32,
                                   real_space_span=31.0, n_classes=3,
                                   device="cpu", chunk=4)
    twin = predictor.model
    assert twin.dilated_upconv and twin.lane_pad == 8
    layouts, outs = [], []
    hooks = [m.register_forward_hook(lambda m, i, o: layouts.append(
        (_channels_last(i[0]), _channels_last(o))))
        for m in twin.modules()
        if isinstance(m, (torch.nn.Conv2d, unet_module._UpConv))]

    def recorded(x):
        outs.append(twin(x))
        return outs[-1]

    stack = torch.randn(32, 32, 8, n_channels,
                        generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        pred = predictor._unet_stack(stack, recorded)
    for h in hooks:
        h.remove()
    # Two chunks of 2 * 2 encoder + 2 bottom + 2 * 3 decoder convs and
    # the out conv; 12 of them run through the epilogue
    assert layouts == [(True, True)] * 26
    assert len(spy) == 24 and not any(spy)
    with torch.inference_mode():
        want = [twin(stack.permute(2, 3, 0, 1)[p:p + 4].contiguous())
                for p in (0, 4)]
    for g, w in zip(outs, want):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, w, rtol=F32_RTOL, atol=0)
    assert torch.equal(pred, torch.cat(outs).permute(2, 3, 0, 1).to(
        torch.bfloat16))


@pytest.mark.parametrize("mode", ["train-grad", "train-no-grad",
                                  "eval-grad"])
@pytest.mark.parametrize("name", ["unet", "unet-dilated-pad8",
                                  "unet-subpixel", "unet3d", "multitask"])
def test_train_mode_and_grad_mode_run_the_ops(spy, name, mode):
    build, shapes, _ = MODELS[name]
    model = build(4, torch.float32)
    model.train(mode.startswith("train"))
    xs = _inputs(shapes, 6)
    with torch.set_grad_enabled(mode.endswith("-grad")):
        outs = _forward(model, xs)
    assert not spy
    if mode == "train-grad":
        sum(o.sum() for o in outs).backward()
        assert all(p.grad is not None for p in model.parameters()
                   if p.requires_grad)


def test_cpu_forward_counts_no_launch():
    model = _unet(1, torch.bfloat16).eval()
    epilogue.unet_epilogue.launches = 0
    trace.take()
    trace.enable()
    try:
        with trace.span("predict.unet"):
            with torch.inference_mode():
                model(torch.randn(1, 2, 16, 16))
    finally:
        trace.disable()
    records = trace.take()
    assert epilogue.unet_epilogue.launches == 0
    assert records["counters"].get("unet.epilogue", 0) == 0
    assert [r["counters"] for r in records["spans"]] == [{}]


def test_takes_and_refuses():
    """The rows the kernel is given: NCHW (rows of the spatial size) and
    channels-last (rows of one element) at ranks 2 and 3, and a refusal
    of any other layout and of a device it does not run on."""
    x = torch.empty(2, 16, 5, 6)
    assert epilogue.row_length(x) == 30
    assert epilogue.row_length(torch.empty(2, 16)) == 1
    assert epilogue.row_length(x.to(memory_format=torch.channels_last)) == 1
    x3 = torch.empty(2, 16, 3, 4, 5).to(
        memory_format=torch.channels_last_3d)
    assert epilogue.row_length(x3) == 1
    for bad in (x[:, ::2], x[..., :5], x.transpose(2, 3), torch.empty(4)):
        with pytest.raises(ValueError, match="NCHW or channels-last"):
            epilogue.row_length(bad)
    x = torch.empty(1, 2, 3, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CPU, or on a CUDA device"):
        epilogue.unet_epilogue(x, torch.zeros(2, device="meta"), True)


# Each reader of the benchmark's trace counters and the counter it reads
READERS = {"predict.unet_epilogue_launches": "unet.epilogue",
           "predict.unet_epilogue_cl_launches": "unet.epilogue_cl"}


def _reader(name):
    return harness.load_file_module(harness.HERE / "metrics" / f"{name}.py",
                                    f"portbench_metric_{name}")


def _unet_span(request, n=None, counter="unet.epilogue"):
    return {"id": 0, "name": "predict.unet", "parent": None, "thread": "t",
            "request": request, "start_ns": 0, "end_ns": 1, "host_ms": 0.0,
            "device_ms": 1.0, "counters": {} if n is None else {counter: n}}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_sums_a_volume_and_averages_the_volumes(name):
    c = READERS[name]
    spans = ([_unet_span(1, 132, c) for _ in range(6)]
             + [_unet_span(2, 132, c) for _ in range(5)]
             + [_unet_span(2, 66, c)])
    rec = {"kind": "predict", "program_spans": {"spans": spans,
                                                "counters": {}}}
    assert _reader(name).read(rec) == pytest.approx((792 + 726) / 2)


def _records(case, counter):
    """A traced run's records in which the reader of `counter` finds
    nothing to read."""
    other = next(c for c in READERS.values() if c != counter)
    spans = {"no-recorder": None,
             "no-counter": [_unet_span(1) for _ in range(6)],
             "other-counter": [_unet_span(1, 132, other) for _ in range(6)],
             "train-run": [_unet_span(1, 132, counter)]}[case]
    return {"kind": "train" if case == "train-run" else "predict",
            "program_spans": None if spans is None else {
                "spans": spans, "counters": {}}}


@pytest.mark.parametrize("case", ["no-recorder", "no-counter",
                                  "other-counter", "train-run"])
@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_none_without_the_counter(name, case):
    assert _reader(name).read(_records(case, READERS[name])) is None
