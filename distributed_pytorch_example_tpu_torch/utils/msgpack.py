"""The port's own copy of the part of ``flax.serialization`` that the
checkpoint uses: ``msgpack_serialize`` (here :func:`msgpack_pieces`) and
:func:`msgpack_restore`.

A pure-Python msgpack encoder and decoder (the card's machine has neither
``msgpack`` nor ``flax``) that writes the bytes flax writes and reads the
bytes flax reads, so a checkpoint crosses between the packages:

- maps with ``str`` keys, written in sorted key order (flax copies the
  tree with ``jax.tree_util.tree_map`` first, which sorts them), arrays
  (lists and tuples), ``int``, ``float`` (always float64), ``str``,
  ``bool``, ``None`` and ``bytes`` (bin), each in msgpack's smallest
  format, with ``strict_types`` (a subclass is not its base: a numpy
  scalar is not a ``float``);
- flax's ext types: ``ndarray = 1`` (a numpy array or a tensor) and
  ``npscalar = 3`` (a numpy scalar), each carrying
  ``packb((shape, dtype.name, tobytes('C')))``. ``'bfloat16'`` decodes to
  a ``torch.bfloat16`` tensor, since numpy has no such dtype;
- flax's chunking: an array leaf of a map above :data:`MAX_CHUNK_SIZE`
  bytes becomes ``{'__msgpack_chunked_array__': True, 'shape': ...,
  'chunks': ...}``, each chunk a flat piece of at most that many bytes.

Arrays cross as numpy, tensors as ``tensor.numpy()`` views (a CPU tensor,
or its bytes for bfloat16). :func:`msgpack_pieces` yields the encoding
as a sequence of buffers without joining them (joined, they are
``msgpack_serialize``'s bytes), so a large payload can be checksummed
and written piece by piece; array payloads are views of the arrays,
never copies. Decoded arrays are views of the input buffer: read
a file into a ``bytearray`` to get writable arrays.
"""

from __future__ import annotations

import struct
from typing import Any, List, Union

import numpy as np
import torch

# flax.serialization.MAX_CHUNK_SIZE: array leaves above it are chunked
MAX_CHUNK_SIZE = 2**30

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"

Buffer = Union[bytes, bytearray, memoryview]


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------


def _int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return struct.pack("B", n)
    if -0x20 <= n < 0:
        return struct.pack("b", n)
    if 0x80 <= n <= 0xFF:
        return struct.pack(">BB", 0xCC, n)
    if -0x80 <= n < 0:
        return struct.pack(">Bb", 0xD0, n)
    if 0xFF < n <= 0xFFFF:
        return struct.pack(">BH", 0xCD, n)
    if -0x8000 <= n < -0x80:
        return struct.pack(">Bh", 0xD1, n)
    if 0xFFFF < n <= 0xFFFFFFFF:
        return struct.pack(">BI", 0xCE, n)
    if -0x80000000 <= n < -0x8000:
        return struct.pack(">Bi", 0xD2, n)
    if 0xFFFFFFFF < n <= 0xFFFFFFFFFFFFFFFF:
        return struct.pack(">BQ", 0xCF, n)
    if -0x8000000000000000 <= n < -0x80000000:
        return struct.pack(">Bq", 0xD3, n)
    raise OverflowError(f"integer {n} does not fit msgpack")


def _sized(n: int, fix: int, fix_max: int, codes, what: str) -> bytes:
    """A length header: the fix form up to ``fix_max``, else the 8-, 16-
    or 32-bit form (``codes``; None where msgpack has no such form)."""
    if fix is not None and n <= fix_max:
        return struct.pack("B", fix | n)
    for code, fmt, top in zip(codes, ("B", ">H", ">I"),
                              (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            return struct.pack("B", code) + struct.pack(fmt, n)
    raise ValueError(f"{what} of {n} does not fit msgpack")


def _str_header(n: int) -> bytes:
    return _sized(n, 0xA0, 0x1F, (0xD9, 0xDA, 0xDB), "string length")


def _bin_header(n: int) -> bytes:
    return _sized(n, None, 0, (0xC4, 0xC5, 0xC6), "bin length")


def _array_header(n: int) -> bytes:
    return _sized(n, 0x90, 0x0F, (None, 0xDC, 0xDD), "array length")


def _map_header(n: int) -> bytes:
    return _sized(n, 0x80, 0x0F, (None, 0xDE, 0xDF), "map length")


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return struct.pack(">Bb", fixed[n], code)
    return _sized(n, None, 0, (0xC7, 0xC8, 0xC9), "ext length") + struct.pack(
        "b", code)


def _as_numpy(x) -> np.ndarray:
    """A C-contiguous numpy array of ``x`` (a view where it already is);
    a bfloat16 tensor becomes its uint16 bits (see :func:`_dtype_name`)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.device.type != "cpu":
            x = x.cpu()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        x = x.numpy()
    return np.asarray(x, order="C")  # ascontiguousarray would make 0-d 1-d


def _dtype_name(x, arr: np.ndarray) -> str:
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        return "bfloat16"
    return arr.dtype.name


def _ndarray_pieces(x) -> List[Buffer]:
    """``packb((shape, dtype.name, tobytes('C')))``: its header pieces and
    the array's own bytes (a view)."""
    arr = _as_numpy(x)
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported for "
                         "serialization of ndarrays.")
    name = _dtype_name(x, arr).encode()
    head = [_array_header(3), _array_header(arr.ndim)]
    head += [_int(int(d)) for d in arr.shape]
    head += [_str_header(len(name)), name, _bin_header(arr.nbytes)]
    data = memoryview(arr.reshape(-1)).cast("B") if arr.nbytes else b""
    return [b"".join(head), data]


def _ext_pieces(code: int, pieces: List[Buffer]) -> List[Buffer]:
    n = sum(len(p) for p in pieces)
    return [_ext_header(code, n)] + pieces


def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.size * x.dtype.itemsize


def _chunk(x) -> dict:
    """flax ``_chunk``: a flat array split into pieces of at most
    MAX_CHUNK_SIZE bytes."""
    itemsize = x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize
    chunksize = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    n = flat.numel() if isinstance(flat, torch.Tensor) else flat.size
    chunks = [flat[i:i + chunksize] for i in range(0, n, chunksize)]
    return {_CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _pieces(obj, out: List[Buffer], in_map: bool, sort: bool = True) -> None:
    # the order of msgpack's Packer._pack with strict_types=True; maps in
    # sorted key order, as flax's tree_map copy leaves them (a chunked
    # array's maps keep flax's insertion order)
    if obj is None:
        out.append(b"\xc0")
    elif type(obj) is bool:
        out.append(b"\xc3" if obj else b"\xc2")
    elif type(obj) is int:
        out.append(_int(obj))
    elif type(obj) in (bytes, bytearray):
        out += [_bin_header(len(obj)), bytes(obj)]
    elif type(obj) is str:
        data = obj.encode("utf-8")
        out += [_str_header(len(data)), data]
    elif type(obj) is float:
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif type(obj) in (list, tuple):
        out.append(_array_header(len(obj)))
        for item in obj:
            _pieces(item, out, in_map=False, sort=sort)
    elif type(obj) is dict:
        out.append(_map_header(len(obj)))
        for key, value in (sorted(obj.items()) if sort else obj.items()):
            _pieces(key, out, in_map=False)
            if in_map and _is_array(value) and _nbytes(value) > MAX_CHUNK_SIZE:
                _pieces(_chunk(value), out, in_map=False, sort=False)
            else:
                _pieces(value, out, in_map=in_map, sort=sort)
    elif _is_array(obj):
        out += _ext_pieces(EXT_NDARRAY, _ndarray_pieces(obj))
    elif isinstance(obj, np.generic):
        out += _ext_pieces(EXT_NPSCALAR, _ndarray_pieces(np.asarray(obj)))
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def msgpack_pieces(tree: Any) -> List[Buffer]:
    """The encoding of ``tree`` as buffers whose concatenation is
    ``flax.serialization.msgpack_serialize(tree)``."""
    out: List[Buffer] = []
    if _is_array(tree) and _nbytes(tree) > MAX_CHUNK_SIZE:
        _pieces(_chunk(tree), out, in_map=False, sort=False)
    else:
        _pieces(tree, out, in_map=True)
    return out


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, data: Buffer):
        self.view = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.view):
            raise ValueError("msgpack data is truncated")
        out = self.view[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]


_FIXED = {
    0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
    0xCA: ">f", 0xCB: ">d",
}
_LEN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",   # bin
        0xD9: ">B", 0xDA: ">H", 0xDB: ">I",   # str
        0xDC: ">H", 0xDD: ">I",               # array
        0xDE: ">H", 0xDF: ">I",               # map
        0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}   # ext
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _decode(r: _Reader, raw: bool):
    b = r.unpack("B")
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _map(r, b & 0x0F, raw)
    if 0x90 <= b <= 0x9F:
        return [_decode(r, raw) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return _str(r.take(b & 0x1F), raw)
    if b == 0xC0:
        return None
    if b == 0xC2:
        return False
    if b == 0xC3:
        return True
    if b in _FIXED:
        return r.unpack(_FIXED[b])
    if b in _FIXEXT:
        code = r.unpack("b")
        return _ext(code, r.take(_FIXEXT[b]))
    if b in _LEN:
        n = r.unpack(_LEN[b])
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(r.take(n))
        if b in (0xD9, 0xDA, 0xDB):
            return _str(r.take(n), raw)
        if b in (0xDC, 0xDD):
            return [_decode(r, raw) for _ in range(n)]
        if b in (0xDE, 0xDF):
            return _map(r, n, raw)
        code = r.unpack("b")
        return _ext(code, r.take(n))
    raise ValueError(f"invalid msgpack byte 0x{b:02x} at {r.pos - 1}")


def _str(data: memoryview, raw: bool):
    return bytes(data) if raw else str(data, "utf-8")


def _map(r: _Reader, n: int, raw: bool) -> dict:
    out = {}
    for _ in range(n):
        key = _decode(r, raw)
        if not isinstance(key, (str, bytes)):
            raise ValueError(f"map key of type {type(key).__name__} is not "
                             "allowed (strict_map_key)")
        out[key] = _decode(r, raw)
    return out


def _ndarray(data: memoryview):
    """flax ``_ndarray_from_bytes``: a view of ``data``; bfloat16 as a
    torch tensor over the same bytes."""
    r = _Reader(data)
    if r.unpack("B") != 0x93:
        raise ValueError("ndarray payload is not a (shape, dtype, data) "
                         "triple")
    shape = _decode(r, raw=True)
    name = _decode(r, raw=True).decode()
    buf = _bin_view(r)
    if name == "bfloat16":
        bits = np.frombuffer(buf, dtype=np.int16).reshape(shape, order="C")
        if not bits.flags.writeable:  # torch wants a writable buffer
            bits = bits.copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape, order="C")


def _ext(code: int, data: memoryview):
    if code == EXT_NDARRAY:
        return _ndarray(data)
    if code == EXT_NPSCALAR:
        return _ndarray(data)[()]
    raise ValueError(f"unknown msgpack ext type {code}")


def _bin_view(r: _Reader) -> memoryview:
    """The bin that an ndarray payload's third field holds, as a view (no
    copy)."""
    b = r.unpack("B")
    if b not in (0xC4, 0xC5, 0xC6):
        raise ValueError("ndarray payload without bin data")
    return r.take(r.unpack(_LEN[b]))


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_in_place(d):
    """flax ``_unchunk_array_leaves_in_place``."""
    if isinstance(d, dict):
        if _CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict) and _CHUNKED in v:
                d[k] = _unchunk(v)
            elif isinstance(v, dict):
                _unchunk_in_place(v)
    return d


def msgpack_restore(data: Buffer) -> Any:
    """``flax.serialization.msgpack_restore``: maps, lists, Python scalars,
    numpy arrays (views of ``data``) and numpy scalars."""
    r = _Reader(data)
    tree = _decode(r, raw=False)
    if r.pos != len(r.view):
        raise ValueError(f"extra data after the msgpack object: "
                         f"{len(r.view) - r.pos} bytes")
    return _unchunk_in_place(tree)

