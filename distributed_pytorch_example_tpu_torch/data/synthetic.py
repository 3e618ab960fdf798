"""Synthetic datasets — no downloads, instant startup (the JAX package's
data/synthetic.py).

The reference's ``SyntheticDataset`` of Gaussian features and uniform
integer labels, Gaussian NHWC images with uniform labels (the vision
configs), and uniform token sequences over the model's vocabulary
(GPT-2's 50257, BERT's 30522). Each draws from the
same ``np.random.default_rng(seed)`` stream as the JAX package's, so the
samples are identical element for element. Map-style, plus a vectorized
``get_batch(indices)`` that the loader prefers.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


class _ArrayDataset:
    """Map-style dataset backed by parallel numpy arrays."""

    def __init__(self, arrays: Dict[str, np.ndarray]):
        lengths = {k: len(v) for k, v in arrays.items()}
        if len(set(lengths.values())) != 1:
            raise ValueError(f"Mismatched array lengths: {lengths}")
        self.arrays = arrays
        self._len = next(iter(lengths.values()))

    def __len__(self) -> int:
        return self._len

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        return {k: v[idx] for k, v in self.arrays.items()}

    def get_batch(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        idx = np.asarray(indices)
        return {k: v[idx] for k, v in self.arrays.items()}


class SyntheticClassificationDataset(_ArrayDataset):
    """Gaussian features + uniform labels; the reference's defaults:
    10,000 samples, 784 features, 10 classes."""

    def __init__(
        self,
        num_samples: int = 10000,
        input_size: int = 784,
        num_classes: int = 10,
        seed: int = 0,
        dtype=np.float32,
    ):
        rng = np.random.default_rng(seed)
        super().__init__(
            {
                "x": rng.standard_normal((num_samples, input_size), dtype=dtype),
                "y": rng.integers(0, num_classes, (num_samples,), dtype=np.int32),
            }
        )
        self.num_classes = num_classes


class SyntheticImageDataset(_ArrayDataset):
    """Gaussian NHWC images + uniform labels for the vision configs:
    ``x`` (num_samples, image_size, image_size, channels), ``y`` int32."""

    def __init__(
        self,
        num_samples: int = 10000,
        image_size: int = 32,
        channels: int = 3,
        num_classes: int = 10,
        seed: int = 0,
        dtype=np.float32,
    ):
        rng = np.random.default_rng(seed)
        super().__init__(
            {
                "x": rng.standard_normal(
                    (num_samples, image_size, image_size, channels),
                    dtype=dtype),
                "y": rng.integers(0, num_classes, (num_samples,),
                                  dtype=np.int32),
            }
        )
        self.num_classes = num_classes


class SyntheticTokenDataset(_ArrayDataset):
    """Uniform int32 token sequences (num_samples, seq_len) over
    ``vocab_size`` ids for the LM configs; the next-token shift or the MLM
    masking happens in the task."""

    def __init__(
        self,
        num_samples: int = 10000,
        seq_len: int = 512,
        vocab_size: int = 50257,
        seed: int = 0,
    ):
        rng = np.random.default_rng(seed)
        super().__init__(
            {
                "tokens": rng.integers(
                    0, vocab_size, (num_samples, seq_len), dtype=np.int32
                ),
            }
        )
        self.vocab_size = vocab_size
        self.seq_len = seq_len
