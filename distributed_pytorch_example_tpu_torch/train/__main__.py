"""``python -m distributed_pytorch_example_tpu_torch.train``: the training
CLI (train/cli.py)."""

import sys

from distributed_pytorch_example_tpu_torch.train.cli import main

if __name__ == "__main__":
    sys.exit(main())
