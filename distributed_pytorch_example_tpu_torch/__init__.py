"""PyTorch/CUDA port of ``distributed_pytorch_example_tpu``.

The JAX package beside this one is the reference. This package mirrors its
subpackage layout and module names so each module's counterpart is easy to
find, and replaces its TPU Pallas kernels with CUDA C++ kernels written for
Hopper (``csrc/``). Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; without a card they raise instead of running on the CPU.

This slice covers GPT-2 serving over the paged KV cache
(``serving/engine.py``) with the paged-decode attention kernel
(``ops/paged_attention.py`` + ``csrc/paged_decode.cu``).
"""
