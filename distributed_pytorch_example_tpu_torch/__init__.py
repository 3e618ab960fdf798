"""PyTorch/CUDA port of ``distributed_pytorch_example_tpu``.

The JAX package beside this one is the reference. This package mirrors its
subpackage layout and module names so each module's counterpart is easy to
find, and replaces its TPU Pallas kernels with CUDA C++ kernels written for
Hopper (``csrc/``). Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; without a card they raise instead of running on the CPU.

Ported so far: GPT-2 serving over the paged KV cache
(``serving/engine.py``) with the paged-decode attention kernel
(``ops/paged_attention.py`` + ``csrc/paged_decode.cu``), and data-parallel
training of SimpleNet and GPT-2 (``train.py`` -> ``train/loop.py``) with
the flash-attention kernels forward and backward
(``ops/flash_attention.py`` + ``csrc/flash_attention.cu``).
"""
