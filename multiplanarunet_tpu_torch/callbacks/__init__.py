"""Training callbacks, the Validation and ValDiceScores callbacks, and
the registry that builds them from a project's YAML."""

from multiplanarunet_tpu_torch.callbacks.callbacks import (  # noqa: F401
    Callback,
    CSVLogger,
    DelayedCallback,
    DividerLine,
    EarlyStopping,
    FGBatchBalancer,
    LearningCurve,
    MeanReduceLogArrays,
    MemoryConsumption,
    ModelCheckPointClean,
    PrintLayerWeights,
    Profiler,
    ReduceLROnPlateau,
    SaveOutputAs2DImage,
    SavePredictionImages,
    TrainTimer,
)
from multiplanarunet_tpu_torch.callbacks.funcs import (  # noqa: F401
    init_callback_objects,
    remove_validation_callbacks,
)
from multiplanarunet_tpu_torch.callbacks.validation import (  # noqa: F401
    ValDiceScores,
    Validation,
)
