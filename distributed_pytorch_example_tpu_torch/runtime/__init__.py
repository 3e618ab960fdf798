"""Runtime: device resolution, rank-tagged logging, the process group and
the process mesh."""

from distributed_pytorch_example_tpu_torch.runtime.device import resolve_device
from distributed_pytorch_example_tpu_torch.runtime.logging import (
    get_logger,
    setup_logging,
)
from distributed_pytorch_example_tpu_torch.runtime.mesh import (
    MeshSpec,
    make_mesh,
)

__all__ = ["MeshSpec", "get_logger", "make_mesh", "resolve_device",
           "setup_logging"]
