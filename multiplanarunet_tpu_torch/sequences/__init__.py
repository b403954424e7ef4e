"""Batch samplers and their factory (`sequences/utils.py:get_sequence`):
the multi-planar slice sampler (iso_live), the isotropic 3D box sampler
(iso_live_3d), the voxel-space patch samplers (patches_3d,
sliding_patches_3d), MultiTaskSequence, one sampler per task, and
RandomDataFeeder over fixed arrays."""

from multiplanarunet_tpu_torch.sequences.base_sequence import (  # noqa: F401
    BaseSequence,
)
from multiplanarunet_tpu_torch.sequences.iso_3d import (  # noqa: F401
    IsotrophicLiveViewSequence3D,
)
from multiplanarunet_tpu_torch.sequences.multi_planar import (  # noqa: F401
    IsotrophicLiveViewSequence,
    IsotrophicLiveViewSequence2D,
)
from multiplanarunet_tpu_torch.sequences.multi_task import (  # noqa: F401
    MultiTaskSequence,
)
from multiplanarunet_tpu_torch.sequences.patches_3d import (  # noqa: F401
    PatchSequence3D,
    SlidingPatchSequence3D,
    center_expand,
)
from multiplanarunet_tpu_torch.sequences.simple_sequences import (  # noqa: F401
    RandomDataFeeder,
)
from multiplanarunet_tpu_torch.sequences.utils import (  # noqa: F401
    get_sequence,
)
