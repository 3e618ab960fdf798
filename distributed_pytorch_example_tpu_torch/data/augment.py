"""Host-side batch augmentation for the vision pipelines (the JAX
package's data/augment.py, its NumPy path).

Augmentations are batch transforms (``fn(batch_dict, rng=None) ->
batch_dict``) applied through :class:`AugmentedDataset`, so they run on
the host in the loader's prefetch thread, overlapped with the step.

- :func:`pad_crop_flip`: zero-pad, random crop back to size, optional
  horizontal flip (the CIFAR-10 recipe; without the flip for data whose
  label mirroring changes, e.g. digits);
- :func:`random_resized_crop_flip`: an area- and aspect-jittered crop,
  resized bilinearly to a square (:func:`_bilinear_resize`), and a flip
  (the ImageNet recipe).

For the same seed every output equals the JAX package's. The JAX
package's C++ resized-crop kernel for uint8 batches (its ``native/``) is
not ported (ROADMAP.md queue 1, item 13): uint8 batches take the NumPy
path here, which the JAX tests hold bit-equal to that kernel.
"""

from __future__ import annotations

import inspect
import threading
from typing import Callable, Dict

import numpy as np

from distributed_pytorch_example_tpu_torch.data.loader import _get_batch
from distributed_pytorch_example_tpu_torch.runtime.logging import get_logger

BatchTransform = Callable[..., Dict[str, np.ndarray]]


class AugmentedDataset:
    """Any map-style dataset with a train-time batch transform.

    The batch is split on a FIXED 32-row chunk grid, and each chunk gets
    its own ``np.random.default_rng((seed, call, chunk))``, so the output
    depends neither on ``workers`` (threads transforming the chunks at
    once; NumPy's gathers and blends release the interpreter lock) nor on
    the machine. A transform without an ``rng`` argument cannot take
    per-chunk generators: it runs on the whole batch, on one thread.
    """

    CHUNK = 32  # the fixed randomness grid; workers change only speed

    def __init__(self, dataset, transform: BatchTransform, workers: int = 1,
                 seed: int = 0):
        self.dataset = dataset
        self.transform = transform
        self.workers = max(1, int(workers))
        self.seed = seed
        self._calls = 0
        self._pool = None
        try:
            self._takes_rng = "rng" in inspect.signature(transform).parameters
        except (TypeError, ValueError):
            self._takes_rng = False
        if self.workers > 1 and not self._takes_rng:
            get_logger(__name__).warning(
                "AugmentedDataset: transform %r has no rng kwarg; running "
                "single-threaded (workers=%d ignored)",
                getattr(transform, "__name__", transform), self.workers)
            self.workers = 1

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, idx: int):
        batch = self.get_batch(np.asarray([idx]))
        return {k: v[0] for k, v in batch.items()}

    def get_batch(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        batch = _get_batch(self.dataset, indices)
        if not self._takes_rng:
            return self.transform(batch)
        n = len(indices)
        call = self._calls
        self._calls += 1
        bounds = list(range(0, n, self.CHUNK)) + [n]
        subs = [{k: v[lo:hi] for k, v in batch.items()}
                for lo, hi in zip(bounds, bounds[1:]) if hi > lo]
        rngs = [np.random.default_rng((self.seed, call, j))
                for j in range(len(subs))]
        if self.workers == 1 or len(subs) == 1:
            parts = [self.transform(s, rng=r) for s, r in zip(subs, rngs)]
        else:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._pool = ThreadPoolExecutor(
                    max_workers=self.workers, thread_name_prefix="augment")
            parts = list(self._pool.map(
                lambda sr: self.transform(sr[0], rng=sr[1]),
                zip(subs, rngs)))
        if len(parts) == 1:
            return parts[0]
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    def close(self) -> None:
        """Stop the worker threads (if any were started)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __getattr__(self, name):  # num_classes etc. pass through
        return getattr(self.dataset, name)


def pad_crop_flip(pad: int = 4, flip: bool = True,
                  seed: int = 0) -> BatchTransform:
    """Zero-pad ``pad``, random-crop back, mirror horizontally with p=0.5.
    Without a per-call ``rng`` the draws come from one generator seeded
    with ``seed``, under a lock."""
    shared_rng = np.random.default_rng(seed)
    rng_lock = threading.Lock()

    def transform(batch: Dict[str, np.ndarray],
                  rng: np.random.Generator = None) -> Dict[str, np.ndarray]:
        x = batch["x"]
        b, h, w, _ = x.shape
        padded = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)),
                        mode="constant")
        if rng is None:
            with rng_lock:
                offs = shared_rng.integers(0, 2 * pad + 1, (b, 2))
                mirror_draw = shared_rng.random(b)
        else:
            offs = rng.integers(0, 2 * pad + 1, (b, 2))
            mirror_draw = rng.random(b)
        out = np.empty_like(x)
        for i in range(b):
            oy, ox = offs[i]
            out[i] = padded[i, oy:oy + h, ox:ox + w]
        if flip:
            mirrored = mirror_draw < 0.5
            out[mirrored] = out[mirrored, :, ::-1]
        return {**batch, "x": out}

    return transform


def _bilinear_resize(crop: np.ndarray, size: int) -> np.ndarray:
    """(H, W, C) -> (size, size, C) bilinear, pixel-center aligned: output
    center i samples input (i + 0.5) * in / out - 0.5, edges clamped
    (``ndimage.zoom(order=1, grid_mode=True, mode='nearest')``), rows
    blended first, then columns; integer inputs are rounded and clipped
    back to their dtype."""
    ch, cw, _ = crop.shape
    dtype = crop.dtype
    ys = (np.arange(size) + 0.5) * (ch / size) - 0.5
    xs = (np.arange(size) + 0.5) * (cw / size) - 0.5
    y0 = np.floor(ys).astype(np.intp)
    x0 = np.floor(xs).astype(np.intp)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    y0c, y1c = np.clip(y0, 0, ch - 1), np.clip(y0 + 1, 0, ch - 1)
    x0c, x1c = np.clip(x0, 0, cw - 1), np.clip(x0 + 1, 0, cw - 1)
    c = crop.astype(np.float32)
    rows = c[y0c] * (1.0 - wy) + c[y1c] * wy
    out = rows[:, x0c] * (1.0 - wx) + rows[:, x1c] * wx
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return np.clip(np.rint(out), info.min, info.max).astype(dtype)
    return out.astype(dtype)


def random_resized_crop_flip(size: int, scale: tuple = (0.35, 1.0),
                             ratio: tuple = (3 / 4, 4 / 3), flip: bool = True,
                             seed: int = 0) -> BatchTransform:
    """Crop a random area (``scale`` of the image) and aspect (``ratio``,
    log-uniform) region, torchvision's 10-try rejection loop with a
    centre-square fallback, resize it bilinearly to ``size`` x ``size``,
    mirror with p=0.5."""
    shared_rng = np.random.default_rng(seed)
    rng_lock = threading.Lock()

    def draw_params(r, b, h, w):
        crops = []
        for _ in range(b):
            for _ in range(10):
                area = h * w * r.uniform(*scale)
                aspect = np.exp(r.uniform(np.log(ratio[0]), np.log(ratio[1])))
                ch = int(round(np.sqrt(area / aspect)))
                cw = int(round(np.sqrt(area * aspect)))
                if 0 < ch <= h and 0 < cw <= w:
                    break
            else:
                ch = cw = min(h, w)
            oy = int(r.integers(0, h - ch + 1))
            ox = int(r.integers(0, w - cw + 1))
            crops.append((oy, ox, ch, cw))
        return crops, r.random(b)

    def transform(batch: Dict[str, np.ndarray],
                  rng: np.random.Generator = None) -> Dict[str, np.ndarray]:
        x = batch["x"]
        b, h, w, c = x.shape
        if rng is None:
            with rng_lock:
                crops, mirror_draw = draw_params(shared_rng, b, h, w)
        else:
            crops, mirror_draw = draw_params(rng, b, h, w)
        mirrored = (mirror_draw < 0.5) if flip else np.zeros(b, bool)
        out = np.empty((b, size, size, c), x.dtype)
        for i, (oy, ox, ch, cw) in enumerate(crops):
            out[i] = _bilinear_resize(x[i, oy:oy + ch, ox:ox + cw], size)
        out[mirrored] = out[mirrored, :, ::-1]
        return {**batch, "x": out}

    return transform
