"""graft-wire: block-quantized gradient collectives (the JAX package's
parallel/wire.py).

Each function here runs on every rank with that rank's local tensor and
moves it across the processes (the JAX functions run inside a shard_map
over the data axis). :class:`WireConfig` selects the payload:

- ``compress="none"``: the library collective itself;
- ``compress="int8-block"``: int8 values with one bf16 scale per
  ``block_size`` elements. int8 partial sums cannot ride a reduction, so
  the quantized reduce-scatter is *split by destination -> quantize ->
  all-to-all -> dequantize -> float32 local sum*, and the quantized psum
  is that reduce-scatter followed by a quantized all-gather of the
  reduced chunk.

Leaves below ``min_size`` elements keep float32. The ZeRO-1 parameter
re-replication is exact (float32) unless ``param_gather`` opts it into
bf16 or int8 blocks (:func:`replicate_params`), because the gathered
parameters are the next step's master weights and their error would
accumulate.

The quantizer keeps the JAX package's arithmetic bit for bit: amax / 127
rounded to bf16 for the scale, 127 / amax (0 for an all-zero block) as
the inverse, round-half-to-even, clip to +-127. Stochastic rounding
(``floor(x + u)``, ``u ~ U[0, 1)``) draws ``u`` from an explicit
``torch.Generator``; its bits differ from JAX's keys.

Gathers (:func:`_gather`) go through the ring all-gather kernel (K3a,
``ops/collectives.py``) when ``ring="auto"``, the tensor is on the card,
there is more than one rank and the payload splits into two 128-element
halves; fused scatter buckets (:func:`_reduce_scatter_rows`) through the
ring reduce-scatter kernel (K3b) on the same terms. Anything else takes
the library collective with the same numbers, as the JAX package falls
back to XLA's.

Leaves walk in the JAX flattened order (``interop.flax_leaves``) and every
tile is cut from the leaf's JAX layout, so tiles, buckets and the block
boundaries that span leaf joins equal JAX's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch

from distributed_pytorch_example_tpu_torch.ops import collectives
from distributed_pytorch_example_tpu_torch.runtime import distributed

COMPRESS_MODES = ("none", "int8-block")
PARAM_GATHER_MODES = ("float32", "bf16", "int8-block")
RING_MODES = ("auto", "off")

# int8 symmetric range: +-127 (128 is reserved so negation stays exact)
_QMAX = 127.0

# leaves below this many ELEMENTS stay on the fp32 collective
DEFAULT_MIN_SIZE = 2048

# default bucket size (bytes of fp32 gradient) when bucketing is asked for
# without a size
DEFAULT_BUCKET_BYTES = 4 * 1024 * 1024


@dataclasses.dataclass(frozen=True)
class WireConfig:
    """Collective-compression policy threaded Trainer -> train/step.py.

    ``compress`` selects the gradient-sync payload ("none" | "int8-block");
    ``block_size`` elements share one bf16 scale; ``stochastic_rounding``
    makes the quantizer unbiased (needs a generator at the call site);
    ``param_gather`` opts the ZeRO-1 re-replication into a lossy gather;
    ``ring`` gates the ring kernels ("auto" | "off"); ``min_size`` is the
    element floor below which leaves keep fp32; ``bucket_bytes`` > 0
    fuses the gradient sync into size-targeted buckets.
    """

    compress: str = "none"
    block_size: int = 256
    stochastic_rounding: bool = False
    param_gather: str = "float32"
    ring: str = "auto"
    min_size: int = DEFAULT_MIN_SIZE
    bucket_bytes: int = 0

    def __post_init__(self):
        if self.compress not in COMPRESS_MODES:
            raise ValueError(
                f"WireConfig.compress must be one of {COMPRESS_MODES}, "
                f"got {self.compress!r}"
            )
        if self.param_gather not in PARAM_GATHER_MODES:
            raise ValueError(
                f"WireConfig.param_gather must be one of "
                f"{PARAM_GATHER_MODES}, got {self.param_gather!r}"
            )
        if self.ring not in RING_MODES:
            raise ValueError(
                f"WireConfig.ring must be one of {RING_MODES}, "
                f"got {self.ring!r}"
            )
        if self.block_size < 1:
            raise ValueError(
                f"WireConfig.block_size must be >= 1, got {self.block_size}"
            )
        if self.bucket_bytes < 0:
            raise ValueError(
                f"WireConfig.bucket_bytes must be >= 0, got "
                f"{self.bucket_bytes}"
            )

    @property
    def active(self) -> bool:
        """Whether any wire surface differs from the raw collectives."""
        return (self.compress != "none" or self.param_gather != "float32"
                or self.bucketed)

    @property
    def bucketed(self) -> bool:
        """Whether gradient sync runs the fused bucketed path."""
        return self.bucket_bytes > 0

    def compresses(self, n_elements: int) -> bool:
        """Whether a leaf of this many elements gets the int8 payload."""
        return self.compress == "int8-block" and n_elements >= self.min_size


# -- block quantizer -------------------------------------------------------


def quantize_blocks(x: torch.Tensor, block_size: int,
                    generator: Optional[torch.Generator] = None):
    """(values int8 (B, block), scales bf16 (B, 1)), one scale per
    ``block_size`` elements of ``x`` flattened; the tail block zero-pads.
    A ``generator`` switches to stochastic rounding."""
    rows, _ = _pad_rows(x.reshape(1, -1), block_size)
    q, scales = _quantize_rows(rows, block_size, generator)
    return q[0], scales[0]


def dequantize_blocks(q, scales, shape, dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_blocks` back to ``shape``."""
    n = math.prod(int(d) for d in shape)
    return _dequantize_rows(q[None], scales[None], n, dtype)[0].reshape(shape)


def _pad_rows(rows: torch.Tensor, block_size: int):
    """(rows zero-padded to a block multiple along axis 1, pad length)."""
    pad = (-rows.shape[1]) % block_size
    if pad:
        rows = torch.nn.functional.pad(rows, (0, pad))
    return rows, pad


def _quantize_rows(rows: torch.Tensor, block_size: int,
                   generator: Optional[torch.Generator] = None):
    """Per-row block quantization: (R, N) -> (R, B, block) int8 +
    (R, B, 1) bf16 scales, N a multiple of block_size."""
    r, n = rows.shape
    blocks = rows.float().reshape(r, n // block_size, block_size)
    amax = blocks.abs().amax(dim=-1, keepdim=True)
    scales = (amax / _QMAX).to(torch.bfloat16)
    # zero blocks: scale 0, inverse 0 — values quantize to 0 exactly
    inv = torch.where(amax > 0.0, _QMAX / torch.clamp(amax, min=1e-30),
                      torch.zeros_like(amax))
    scaled = blocks * inv
    if generator is not None:
        # unbiased: floor(x + u), u ~ U[0,1) per element
        u = torch.rand(scaled.shape, generator=generator,
                       device=scaled.device)
        rounded = torch.floor(scaled + u)
    else:
        rounded = torch.round(scaled)  # half to even, as jnp.round
    q = torch.clamp(rounded, -_QMAX, _QMAX).to(torch.int8)
    return q, scales


def _dequantize_rows(q, scales, n: int, dtype=torch.float32) -> torch.Tensor:
    """(R, B, block) int8 + (R, B, 1) bf16 -> (R, n) ``dtype``."""
    vals = q.float() * scales.float()
    return vals.reshape(q.shape[0], -1)[:, :n].to(dtype)


# -- collective drop-ins (every rank calls them with its local tensor) ----


def _scatter_parts(g: torch.Tensor, dim: int, d: int):
    """((d, n/d) destination-major rows, per-rank chunk shape) of one
    scatterable leaf: row j is the flattened chunk bound for rank j, and
    the chunk shape is the tiled ``psum_scatter`` output shape."""
    chunk = g.shape[dim] // d
    parts = g.reshape(g.shape[:dim] + (d, chunk) + g.shape[dim + 1:])
    parts = parts.movedim(dim, 0)
    return parts.reshape(d, -1), tuple(parts.shape[1:])


def _unscatter(rows: torch.Tensor, dim: int, chunk_shape) -> torch.Tensor:
    """Inverse of :func:`_scatter_parts`: (d, n/d) rows -> the full leaf,
    the chunks concatenated along ``dim``."""
    d = rows.shape[0]
    parts = rows.reshape((d,) + tuple(chunk_shape)).movedim(0, dim)
    shape = list(chunk_shape)
    shape[dim] *= d
    return parts.reshape(shape)


def wire_psum_scatter(x: torch.Tensor, *, scatter_dimension: int,
                      config: Optional[WireConfig] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
    """Tiled reduce-scatter of ``x`` along ``scatter_dimension``, with
    optional int8 payloads (quantize each destination chunk, all-to-all,
    dequantize, sum in float32)."""
    config = config or WireConfig()
    d = distributed.process_count()
    dim = scatter_dimension
    if x.shape[dim] % d:
        raise ValueError(
            f"scatter dimension {dim} of shape {tuple(x.shape)} must divide "
            f"the 'data' span {d}"
        )
    rows, chunk_shape = _scatter_parts(x, dim, d)
    if not config.compresses(x.numel()):
        return distributed.reduce_scatter_tiled(rows).reshape(chunk_shape)
    padded, _ = _pad_rows(rows, config.block_size)
    q, scales = _quantize_rows(
        padded, config.block_size,
        generator if config.stochastic_rounding else None,
    )
    q = distributed.all_to_all_rows(q)
    scales = distributed.all_to_all_rows(scales)
    got = _dequantize_rows(q, scales, rows.shape[1])  # one row per source
    return got.sum(dim=0).reshape(chunk_shape)


def wire_all_gather(x: torch.Tensor, *, gather_dimension: int = 0,
                    config: Optional[WireConfig] = None,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """Tiled all-gather along ``gather_dimension`` with optional int8
    payloads: quantize the local shard once, gather values and scales
    (through K3a where eligible), dequantize every rank's part."""
    config = config or WireConfig()
    if not config.compresses(x.numel()):
        return _gather(x, gather_dimension, config)
    rows, _ = _pad_rows(x.reshape(1, -1), config.block_size)
    q, scales = _quantize_rows(
        rows, config.block_size,
        generator if config.stochastic_rounding else None,
    )
    q = _gather(q, 0, config)            # (d, B, block) int8
    scales = _gather(scales, 0, config)  # (d, B, 1) bf16
    got = _dequantize_rows(q, scales, x.numel(), x.dtype)
    parts = got.reshape((got.shape[0],) + tuple(x.shape))
    return torch.cat(list(parts.unbind(0)), dim=gather_dimension)


def wire_psum(x: torch.Tensor, *, config: Optional[WireConfig] = None,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """All-reduce sum with optional int8 payloads: the quantized
    reduce-scatter of the flattened leaf (padded to a rank multiple),
    then a quantized all-gather of the reduced chunk."""
    config = config or WireConfig()
    if not config.compresses(x.numel()):
        return distributed.all_reduce_sum_(x.clone())
    gen = generator if config.stochastic_rounding else None
    full = _quantized_psum_flat(x.reshape(-1), config, gen, stream=0)
    return full.reshape(x.shape).to(x.dtype)


def _quantized_psum_flat(flat: torch.Tensor, config: WireConfig, generator,
                         stream: int) -> torch.Tensor:
    d = distributed.process_count()
    n = flat.numel()
    pad = (-n) % d
    padded = torch.nn.functional.pad(flat, (0, pad)) if pad else flat
    chunks = padded.reshape(d, -1)  # one destination chunk per rank
    rows, _ = _pad_rows(chunks, config.block_size)
    q, scales = _quantize_rows(rows, config.block_size, generator)
    q = distributed.all_to_all_rows(q)
    scales = distributed.all_to_all_rows(scales)
    reduced = _dequantize_rows(q, scales, chunks.shape[1]).sum(dim=0)
    rows2, _ = _pad_rows(reduced[None], config.block_size)
    q2, scales2 = _quantize_rows(rows2, config.block_size, generator)
    q2 = _gather(q2, 0, config, stream=stream)
    scales2 = _gather(scales2, 0, config, stream=stream)
    full = _dequantize_rows(q2, scales2, chunks.shape[1]).reshape(-1)
    return full[:n] if pad else full


def _gather(x: torch.Tensor, gather_dimension: int, config: WireConfig,
            stream: int = 0) -> torch.Tensor:
    """Tiled all-gather: K3a where it takes the payload (``ring="auto"``,
    dim 0, on the card, more than one rank, two 128-element halves), the
    library gather otherwise. ``stream`` picks the kernel's buffer set."""
    if (config.ring != "off" and gather_dimension == 0
            and collectives.ring_eligible(x, distributed.process_count())):
        return collectives.ring_all_gather(x, stream=stream)
    return distributed.all_gather_tiled(x, dim=gather_dimension)


# -- bucketed gradient sync -------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One fused gradient-sync bucket (shapes only): ``kind`` "scatter"
    (one fused reduce-scatter) or "psum" (one fused all-reduce);
    ``leaves`` are indices into the JAX-order leaf list."""

    index: int
    kind: str
    leaves: Tuple[int, ...]
    elements: int
    fp32_bytes: int
    wire_bytes: int

    def to_json(self) -> dict:
        return {
            "index": self.index,
            "kind": self.kind,
            "num_leaves": len(self.leaves),
            "elements": self.elements,
            "fp32_bytes": self.fp32_bytes,
            "wire_bytes": self.wire_bytes,
        }


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """The static bucket schedule :func:`sync_grads` executes, in issue
    order (reverse leaf order: the backward makes the last layers'
    gradients first)."""

    buckets: Tuple[Bucket, ...]
    bucket_bytes: int
    axis_size: int

    def to_json(self) -> dict:
        return {
            "bucket_bytes": self.bucket_bytes,
            "axis_size": self.axis_size,
            "num_buckets": len(self.buckets),
            "buckets": [b.to_json() for b in self.buckets],
        }


def _numel(leaf) -> int:
    if hasattr(leaf, "numel"):
        return int(leaf.numel())
    return int(math.prod(int(s) for s in leaf))


def plan_buckets(dims: Sequence[Optional[int]], grads: Sequence,
                 config: WireConfig, axis_size: int,
                 bucket_bytes: Optional[int] = None) -> BucketPlan:
    """Greedy size-targeted buckets over the leaves (JAX order): walk them
    in reverse, append each to the open bucket of its kind, seal a bucket
    once its fp32 size reaches ``bucket_bytes``. ``grads`` holds tensors
    or shapes; zero-size leaves are skipped."""
    if bucket_bytes is None:
        bucket_bytes = config.bucket_bytes or DEFAULT_BUCKET_BYTES
    if len(dims) != len(grads):
        raise ValueError(
            f"dims/grads leaf mismatch: {len(dims)} vs {len(grads)}"
        )
    d = max(int(axis_size), 1)
    ring_factor = (d - 1) / d if d > 1 else 0.0
    buckets: List[Bucket] = []
    open_leaves: dict = {"scatter": [], "psum": []}
    open_elems: dict = {"scatter": 0, "psum": 0}

    def seal(kind: str) -> None:
        ids = open_leaves[kind]
        if not ids:
            return
        n = open_elems[kind]
        passes = 1.0 if kind == "scatter" else 2.0  # RS vs AR (RS + AG)
        wire = passes * ring_factor * n * _bytes_per_element(config, n)
        buckets.append(Bucket(
            index=len(buckets), kind=kind, leaves=tuple(ids),
            elements=n, fp32_bytes=n * 4, wire_bytes=int(round(wire)),
        ))
        open_leaves[kind] = []
        open_elems[kind] = 0

    for i in reversed(range(len(grads))):
        n = _numel(grads[i])
        if n == 0:
            continue
        kind = "scatter" if dims[i] is not None else "psum"
        open_leaves[kind].append(i)
        open_elems[kind] += n
        if open_elems[kind] * 4 >= bucket_bytes:
            seal(kind)
    seal("scatter")
    seal("psum")
    return BucketPlan(buckets=tuple(buckets), bucket_bytes=int(bucket_bytes),
                      axis_size=d)


def _reduce_scatter_rows(buf: torch.Tensor, config: WireConfig,
                         stream: int) -> torch.Tensor:
    """Fused fp32 reduce-scatter of a (d, n/d) destination-major buffer
    -> this rank's reduced (n/d,) row: K3b where it takes the chunk (one
    buffer set per ``stream``), the library reduce-scatter otherwise."""
    if (config.ring != "off" and buf.is_cuda and buf.shape[0] > 1
            and collectives.half_rows(buf.shape[1]) is not None):
        return collectives.ring_reduce_scatter(buf, stream=stream).reshape(-1)
    return distributed.reduce_scatter_tiled(buf).reshape(-1)


def _bucket_scatter(out, leaves, dims, bucket: Bucket, d: int,
                    config: WireConfig, generator, scale: float) -> None:
    """One fused scatter bucket: every leaf to destination-major rows,
    joined along the row, ONE collective, split back per leaf. Blocks of
    a quantized bucket span leaf joins."""
    parts, chunk_shapes = [], []
    for i in bucket.leaves:
        rows, cs = _scatter_parts(leaves[i], dims[i], d)
        parts.append(rows)
        chunk_shapes.append(cs)
    buf = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    nb = buf.shape[1]
    if config.compresses(bucket.elements):
        rows, _ = _pad_rows(buf, config.block_size)
        q, scales = _quantize_rows(
            rows, config.block_size,
            generator if config.stochastic_rounding else None,
        )
        q = distributed.all_to_all_rows(q)
        scales = distributed.all_to_all_rows(scales)
        red = _dequantize_rows(q, scales, nb).sum(dim=0)
    else:
        red = _reduce_scatter_rows(buf.contiguous(), config, bucket.index)
    red = red * scale
    offset = 0
    for i, cs in zip(bucket.leaves, chunk_shapes):
        n_i = math.prod(cs)
        out[i] = red[offset:offset + n_i].reshape(cs)
        offset += n_i


def _bucket_psum(out, leaves, bucket: Bucket, config: WireConfig,
                 generator, scale: float) -> None:
    """One fused all-reduce bucket over the unsharded leaves."""
    flats = [leaves[i].reshape(-1) for i in bucket.leaves]
    flat = flats[0].clone() if len(flats) == 1 else torch.cat(flats)
    if config.compresses(bucket.elements):
        full = _quantized_psum_flat(
            flat, config,
            generator if config.stochastic_rounding else None,
            stream=bucket.index,
        )
    else:
        full = distributed.all_reduce_sum_(flat)
    full = full * scale
    offset = 0
    for i in bucket.leaves:
        leaf = leaves[i]
        out[i] = full[offset:offset + leaf.numel()].reshape(leaf.shape)
        offset += leaf.numel()


def sync_grads(grads: Sequence[torch.Tensor], dims: Sequence[Optional[int]],
               *, config: Optional[WireConfig] = None,
               generator: Optional[torch.Generator] = None,
               scale: float = 1.0,
               plan: Optional[BucketPlan] = None) -> List[torch.Tensor]:
    """The gradient-sync dispatcher of the ZeRO-1 / wire step.

    ``grads`` are this rank's local float32 gradients in the JAX layout
    and order; leaves with a ZeRO-1 dim reduce-scatter to this rank's
    tile, the rest all-reduce, every payload per ``config``, and the
    results are scaled by ``scale`` (the global-mean factor). With
    ``bucket_bytes == 0`` one collective per leaf; otherwise
    :func:`plan_buckets`'s fused buckets, in issue order.
    """
    config = config or WireConfig()
    gen = generator if config.stochastic_rounding else None
    if not config.bucketed:
        synced = []
        for dim, g in zip(dims, grads):
            if dim is not None:
                g = wire_psum_scatter(g, scatter_dimension=dim,
                                      config=config, generator=gen)
            else:
                g = wire_psum(g, config=config, generator=gen)
            synced.append(g * scale)
        return synced
    d = distributed.process_count()
    if plan is None:
        plan = plan_buckets(dims, grads, config, d)
    out: list = list(grads)  # zero-size leaves pass through unsynced
    for bucket in plan.buckets:
        if bucket.kind == "scatter":
            _bucket_scatter(out, grads, dims, bucket, d, config, gen, scale)
        else:
            _bucket_psum(out, grads, bucket, config, gen, scale)
    return out


# -- ZeRO-1 parameter re-replication ----------------------------------------


def replicate_params(tiles: Sequence[torch.Tensor],
                     dims: Sequence[Optional[int]],
                     config: WireConfig) -> List[torch.Tensor]:
    """The wire-configured ZeRO-1 re-replication: each tile (this rank's
    part of a scatter leaf, JAX layout) gathers back along its dim as
    bf16 (``param_gather="bf16"``) or through :func:`wire_all_gather`
    (``"int8-block"``, which compresses only when ``compress`` does);
    leaves without a dim pass through. The result keeps the tiles'
    dtype."""
    out = []
    for dim, p in zip(dims, tiles):
        if dim is None:
            out.append(p)
        elif config.param_gather == "bf16":
            out.append(_gather(p.to(torch.bfloat16), dim, config).to(p.dtype))
        else:
            out.append(wire_all_gather(p, gather_dimension=dim,
                                       config=config).to(p.dtype))
    return out


# -- analytic wire accounting ----------------------------------------------


def _bytes_per_element(config: WireConfig, n: int) -> float:
    """Per-element payload bytes of ONE wire pass for an n-element leaf."""
    if config.compresses(n):
        return 1.0 + 2.0 / config.block_size  # 1 s8 byte + a bf16 scale
    return 4.0  # f32


def grad_wire_report(shapes, partitioner,
                     config: Optional[WireConfig] = None) -> dict:
    """Analytic per-rank gradient-sync wire bytes per optimizer step:
    ring accounting per leaf of n elements over D ranks, (D-1)/D * n for
    a reduce-scatter leaf and twice that for an all-reduced one.
    ``shapes`` maps the JAX param paths to their shapes."""
    if config is None:
        config = getattr(partitioner, "wire", None) or WireConfig()
    d = int(partitioner.mesh_shape.get(partitioner.grad_sync_axis(), 1))
    if partitioner.dp_shard_opt_state:
        dims = partitioner.zero1_dims(shapes)
    else:
        dims = {path: None for path in shapes}
    fp32_bytes = 0.0
    wire_bytes = 0.0
    ring_factor = (d - 1) / d if d > 1 else 0.0
    for path, shape in shapes.items():
        n = _numel(shape)
        passes = 1.0 if dims[path] is not None else 2.0
        fp32_bytes += passes * ring_factor * n * 4.0
        wire_bytes += passes * ring_factor * n * _bytes_per_element(config, n)
    ratio = fp32_bytes / wire_bytes if wire_bytes else 1.0
    return {
        "compress": config.compress,
        "block_size": config.block_size,
        "dp_degree": d,
        "grad_wire_bytes_per_step_fp32": int(round(fp32_bytes)),
        "grad_wire_bytes_per_step": int(round(wire_bytes)),
        "wire_compression_ratio": round(ratio, 3),
    }
