"""Training: optimizers, train and eval steps, the Trainer. The JAX
package's TrainState / create_train_state / make_train_step /
make_eval_step are flax idioms; their counterparts here are the step
objects TrainStep and EvalStep (and the multi-task ones)."""

from multiplanarunet_tpu_torch.train.train_step import (  # noqa: F401
    EvalStep,
    MultiTaskEvalStep,
    MultiTaskTrainStep,
    TrainStep,
)
from multiplanarunet_tpu_torch.train.trainer import Trainer  # noqa: F401
