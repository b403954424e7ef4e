"""3D U-Net, in torch (NCDHW), for inference and training.

Port of `multiplanarunet_tpu/models/unet3d.py:UNet3D`: the 2D model's
topology over three spatial axes, on the same building blocks
(`models/unet.py`, rank 3): an encoder of [conv k^3 SAME -> act] x2 ->
BatchNorm -> maxpool 2^3, a bottom block, a decoder of [nearest 2x
upsample -> conv 2^3 SAME, padded (0, 1) on the high edge of all three
axes -> act -> BatchNorm -> crop skip -> concat [skip, up] -> block], a
float32 1^3 out conv, and `label_crop` as a (3, 2) array. The default
depth is 3. The JAX model's `subpixel_decoder` and `dilated_upconv` are
inference restructurings that are off by default and not ported.
"""

from __future__ import annotations

from multiplanarunet_tpu_torch.models.unet import UNet


class UNet3D(UNet):
    """forward: (B, n_channels, D, H, W) -> (B, n_classes, D', H', W')
    float32 outputs of out_activation."""

    ndim = 3

    def __init__(self, n_classes, n_channels=1, depth=3,
                 complexity_factor=1.0, **kwargs):
        super().__init__(n_classes, n_channels, depth, complexity_factor,
                         **kwargs)
