"""Tokenized text from local files (the JAX package's data/text.py).

For the LM configs (BERT MLM, GPT-2) on a real corpus: a flat array of
token ids on disk (``.npy`` of any integer dtype, or a raw ``.bin`` of
``--token-dtype``, uint16 covering GPT-2's and BERT's vocabularies) is cut
into fixed-length windows. Masking and the next-token shift stay in the
task, so the loader ships raw ids. Nothing is downloaded or tokenized
here: a missing file raises, pointing at ``--dataset synthetic-tokens``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from distributed_pytorch_example_tpu_torch.data import intake


class TokenWindowDataset:
    """Fixed-length windows over a flat token-id array: sample ``i`` is
    ``ids[i * stride : i * stride + seq_len]`` (``stride`` defaults to
    ``seq_len``: windows that neither overlap nor leave gaps). Map-style,
    with the vectorized ``get_batch`` the loader prefers; windows become
    int32 when they are gathered, so ``ids`` may stay a memory map."""

    def __init__(self, ids: np.ndarray, seq_len: int,
                 stride: Optional[int] = None):
        if ids.ndim != 1:
            raise ValueError(f"expected flat token array, got shape {ids.shape}")
        self.ids = ids
        self.seq_len = seq_len
        self.stride = stride or seq_len
        n = (len(ids) - seq_len) // self.stride + 1
        if n <= 0:
            raise ValueError(
                f"corpus of {len(ids)} tokens shorter than one window of "
                f"{seq_len}"
            )
        self._len = n

    def __len__(self) -> int:
        return self._len

    def __getitem__(self, idx: int):
        lo = idx * self.stride
        return {"tokens": np.asarray(self.ids[lo:lo + self.seq_len], np.int32)}

    def get_batch(self, indices: Sequence[int]):
        starts = np.asarray(indices, dtype=np.int64) * self.stride
        offsets = np.arange(self.seq_len, dtype=np.int64)
        out = self.ids[starts[:, None] + offsets[None, :]]
        return {"tokens": np.asarray(out, np.int32)}


def write_token_file(path: str, ids: np.ndarray, seal: bool = True) -> str:
    """Write a flat token array as ``.npy`` or raw ``.bin`` (its own
    dtype); ``seal`` adds the ``DPX-CRC1`` sidecar that
    :func:`load_token_file` checks."""
    ids = np.asarray(ids)
    if ids.ndim != 1:
        raise ValueError(f"expected flat token array, got shape {ids.shape}")
    if path.endswith(".npy"):
        np.save(path, ids)
    else:
        ids.tofile(path)
    if seal:
        intake.seal_file(path)
    return path


def load_token_file(path: str, seq_len: int, dtype: str = "uint16",
                    stride: Optional[int] = None,
                    verify: bool = True) -> TokenWindowDataset:
    """Windows over a corpus in ``.npy`` or raw little-endian ``.bin`` of
    ``dtype``, memory-mapped either way (pages fault in as windows are
    gathered). With ``verify``, a corpus with a sidecar is checked once at
    open and a mismatch raises :class:`~.intake.ShardCorruptError`; one
    without a sidecar loads unverified."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"Token file {path!r} not found. Nothing is downloaded: "
            "pre-tokenize offline, or use --dataset synthetic-tokens."
        )
    if verify and intake.verify_file(path) is False:
        raise intake.ShardCorruptError(
            f"{path}: token file failed its DPX-CRC1 sidecar check (corrupt "
            "corpus: re-run the offline tokenize, or pass verify=False to "
            "load it anyway)"
        )
    if path.endswith(".npy"):
        ids = np.load(path, mmap_mode="r")
    else:
        ids = np.memmap(path, dtype=np.dtype(dtype), mode="r")
    return TokenWindowDataset(ids, seq_len=seq_len, stride=stride)
