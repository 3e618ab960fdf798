"""Training: tasks, optimizers, the data-parallel train/eval steps, the
epoch loop, checkpoints and the CLI
(``python -m distributed_pytorch_example_tpu_torch.train``)."""

from distributed_pytorch_example_tpu_torch.robustness import (
    BadStepBudgetExceeded,
)
from distributed_pytorch_example_tpu_torch.train.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from distributed_pytorch_example_tpu_torch.train.cli import main
from distributed_pytorch_example_tpu_torch.train.loop import (
    PreemptionInterrupt,
    Trainer,
)
from distributed_pytorch_example_tpu_torch.train.metrics import (
    MetricAccumulator,
)
from distributed_pytorch_example_tpu_torch.train.optimizers import (
    Optimizer,
    make_optimizer,
    make_schedule,
)
from distributed_pytorch_example_tpu_torch.train.state import TrainState
from distributed_pytorch_example_tpu_torch.train.step import (
    build_eval_step,
    build_train_step,
)
from distributed_pytorch_example_tpu_torch.train.tasks import (
    CausalLMTask,
    ClassificationTask,
)

__all__ = [
    "BadStepBudgetExceeded",
    "CausalLMTask",
    "ClassificationTask",
    "MetricAccumulator",
    "Optimizer",
    "PreemptionInterrupt",
    "TrainState",
    "Trainer",
    "build_eval_step",
    "build_train_step",
    "load_checkpoint",
    "main",
    "make_optimizer",
    "make_schedule",
    "save_checkpoint",
]
