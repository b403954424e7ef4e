"""The frozen FLOP counts against a count of the reference model's
convolutions (torch's FlopCounterMode: 2 x multiply-adds of each conv),
at small sizes and at the configurations' own sizes on the meta
device."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import arith, harness, traffic
from portbench.reference import unet


def counted(build, device):
    ndim = 3 if build["model_class_name"] == "UNet3D" else 2
    tree = traffic.make_weights(build, 0, "cpu")
    tree = {c: {k: _to(v, device) for k, v in t.items()}
            for c, t in tree.items()}
    x = torch.zeros((1, int(build["n_channels"]))
                    + (int(build["dim"]),) * ndim, device=device)
    with FlopCounterMode(display=False) as fc:
        unet.forward(tree["params"], tree["batch_stats"], x,
                     int(build["depth"]))
    return fc.get_total_flops()


def _to(v, device):
    if isinstance(v, dict):
        return {k: _to(x, device) for k, x in v.items()}
    return v.to(device)


SMALL = [
    {"model_class_name": "UNet", "n_classes": 3, "n_channels": 1, "dim": 32,
     "depth": 2, "complexity_factor": 2, "init_filters": 8},
    {"model_class_name": "UNet", "n_classes": 5, "n_channels": 2, "dim": 64,
     "depth": 3, "complexity_factor": 1, "init_filters": 4},
    {"model_class_name": "UNet3D", "n_classes": 3, "n_channels": 1,
     "dim": 16, "depth": 2, "complexity_factor": 1, "init_filters": 4},
]


@pytest.mark.parametrize("build", SMALL)
def test_small(build):
    assert counted(build, "cpu") == arith.config_forward_flops(build)


@pytest.mark.parametrize("name,gflop", [("mpunet2d-cf2-d4", 217.6),
                                        ("unet3d-cf1-d3", 499.8)])
def test_configurations(name, gflop):
    build = harness.load_json(harness.HERE / "configs" / f"{name}.json")[
        "build"]
    flops = arith.config_forward_flops(build)
    assert round(flops / 1e9, 1) == gflop
    assert counted(build, "meta") == flops


def test_frozen_copy_matches_the_2d_count():
    # multiplanarunet_tpu_torch/utils/conv_arithmetics.py's count, as it
    # stood when it was copied
    assert arith.unet_forward_flops(256, 7, 1, 4, 64, 2.0) == 217611780096.0
