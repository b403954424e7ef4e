"""Models: the 2D U-Net, the 3D U-Net, the multi-task U-Net, the fusion
model, the Swin UNETR, their construction and weight files
(`checkpoint`)."""

from multiplanarunet_tpu_torch.models import checkpoint  # noqa: F401
from multiplanarunet_tpu_torch.models.fusion_model import (  # noqa: F401
    FusionModel,
)
from multiplanarunet_tpu_torch.models.model_init import (  # noqa: F401
    MODELS,
    build_model,
    init_model_variables,
    model_initializer,
)
from multiplanarunet_tpu_torch.models.multitask_unet import (  # noqa: F401
    MultiTaskUNet2D,
)
from multiplanarunet_tpu_torch.models.swin_unetr import (  # noqa: F401
    SwinUNETR,
)
from multiplanarunet_tpu_torch.models.unet import UNet  # noqa: F401
from multiplanarunet_tpu_torch.models.unet3d import UNet3D  # noqa: F401
