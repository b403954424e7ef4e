"""Models: the 2D U-Net, the 3D U-Net, the multi-task U-Net, the fusion
model, their construction and weight loading."""

from multiplanarunet_tpu_torch.models.model_init import (
    MODELS,
    build_model,
    model_initializer,
)
from multiplanarunet_tpu_torch.models.multitask_unet import MultiTaskUNet2D
from multiplanarunet_tpu_torch.models.unet import UNet
from multiplanarunet_tpu_torch.models.unet3d import UNet3D
