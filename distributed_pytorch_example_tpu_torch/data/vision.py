"""Real vision datasets from local files (the JAX package's data/vision.py).

Nothing is downloaded. Each loader reads a standard on-disk format and,
when the files are absent, raises with guidance to use the synthetic
images instead (``--dataset synthetic-image``):

- CIFAR-10: the canonical python-pickle batches (``cifar-10-batches-py/``),
  as normalized float32 NHWC;
- scikit-learn's bundled optical digits (1797 8x8 images; sklearn is
  imported only when asked for), upscaled and stacked to 3 channels;
- ImageFolder-style ``<root>/<class>/*.npy`` arrays (pre-decoded NHWC).

The datasets expose the map-style + ``get_batch`` interface of
``data/synthetic.py``, so the loader treats them alike; the arrays equal
the JAX package's for the same files.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np

from distributed_pytorch_example_tpu_torch.data.synthetic import _ArrayDataset

CIFAR10_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR10_STD = np.array([0.2470, 0.2435, 0.2616], np.float32)


def data_root(data_dir: Optional[str]) -> str:
    """``data_dir``, else ``$DPX_DATA_DIR``, else ``./data``."""
    return data_dir or os.environ.get("DPX_DATA_DIR", "./data")


class Cifar10Dataset(_ArrayDataset):
    """CIFAR-10 as float32 NHWC with int32 labels."""

    num_classes = 10

    def __init__(self, images: np.ndarray, labels: np.ndarray):
        super().__init__({"x": images, "y": labels})


def load_cifar10(train: bool = True, data_dir: Optional[str] = None,
                 normalize: bool = True) -> Cifar10Dataset:
    """CIFAR-10 from ``<data_dir>/cifar-10-batches-py/{data_batch_1..5,
    test_batch}`` (the canonical ``cifar-10-python.tar.gz`` extraction):
    each row's 3072 bytes are CHW planes, returned NHWC in [0, 1] and, with
    ``normalize``, standardised per channel."""
    root = os.path.join(data_root(data_dir), "cifar-10-batches-py")
    names = ([f"data_batch_{i}" for i in range(1, 6)] if train
             else ["test_batch"])
    paths = [os.path.join(root, n) for n in names]
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(
            f"CIFAR-10 batch files not found (first missing: {missing[0]}). "
            "This environment has no network egress — place the extracted "
            "cifar-10-batches-py/ under the data dir, or use "
            "--dataset synthetic-image for a download-free run."
        )
    images, labels = [], []
    for path in paths:
        with open(path, "rb") as f:
            batch = pickle.load(f, encoding="bytes")
        images.append(batch[b"data"].reshape(-1, 3, 32, 32)
                      .transpose(0, 2, 3, 1))
        labels.append(np.asarray(batch[b"labels"], np.int32))
    x = np.concatenate(images).astype(np.float32) / 255.0
    y = np.concatenate(labels)
    if normalize:
        x = (x - CIFAR10_MEAN) / CIFAR10_STD
    return Cifar10Dataset(x, y)


def load_digits(train: bool = True, upscale: int = 4,
                val_fraction: float = 0.2,
                normalize: bool = True) -> _ArrayDataset:
    """scikit-learn's bundled handwritten digits (1797 8x8 grayscale
    images, no download): upscaled ``upscale`` x (nearest), stacked to 3
    channels, split train/val by a fixed permutation (seed 1234) and, with
    ``normalize``, standardised by the whole set's mean and std."""
    try:
        from sklearn.datasets import load_digits as _sk_load_digits
    except ImportError as e:
        raise ImportError(
            "scikit-learn is required for --dataset digits") from e

    bunch = _sk_load_digits()
    images = bunch.images.astype(np.float32) / 16.0  # (N, 8, 8) in [0, 1]
    labels = bunch.target.astype(np.int32)
    order = np.random.default_rng(1234).permutation(len(images))
    n_val = int(len(images) * val_fraction)
    idx = order[n_val:] if train else order[:n_val]
    x = images[idx]
    if upscale > 1:
        x = np.kron(x, np.ones((1, upscale, upscale), np.float32))
    x = np.repeat(x[..., None], 3, axis=-1)
    if normalize:
        mean, std = images.mean(), images.std() + 1e-8
        x = (x - mean) / std
    ds = _ArrayDataset({"x": x, "y": labels[idx]})
    ds.num_classes = 10
    return ds


def load_image_folder(root: str, image_size: int = 224) -> _ArrayDataset:
    """``<root>/<class>/*.npy`` NHWC arrays of ``image_size`` square, as
    float32; sorted class directory names are the label ids (torchvision's
    ImageFolder convention). For sets that fit in host memory."""
    if not os.path.isdir(root):
        raise FileNotFoundError(
            f"ImageFolder root {root!r} does not exist. Use "
            "--dataset synthetic-image in zero-egress environments."
        )
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    if not classes:
        raise FileNotFoundError(f"No class directories under {root!r}")
    xs, ys = [], []
    for label, cls in enumerate(classes):
        for fname in sorted(os.listdir(os.path.join(root, cls))):
            if fname.endswith(".npy"):
                arr = np.load(os.path.join(root, cls, fname))
                if arr.shape[:2] != (image_size, image_size):
                    raise ValueError(
                        f"{fname}: expected {image_size}x{image_size} NHWC, "
                        f"got {arr.shape}"
                    )
                xs.append(arr.astype(np.float32))
                ys.append(label)
    if not xs:
        raise FileNotFoundError(
            f"No .npy arrays under {root!r} class dirs (this loader reads "
            "pre-decoded NHWC .npy, not raw images). Use --dataset "
            "synthetic-image, or pre-decode offline."
        )
    return _ArrayDataset({"x": np.stack(xs), "y": np.asarray(ys, np.int32)})
