"""Checkpoint integrity envelope: CRC32-sealed msgpack blobs (the JAX
package's robustness/integrity.py).

Every checkpoint file is written wrapped in a small self-describing
envelope::

    b"DPX-CRC1\\n" + <4-byte little-endian crc32 of body> + <body>

so the loader tells "file exists but is torn or bit-flipped" from "file
is intact" before msgpack parsing: a truncated msgpack blob can decode
into a silently wrong tree, which is far worse than a loud failure. Files
without the envelope (written before it existed) pass through
:func:`unseal` unverified. The bytes equal the JAX package's, so either
package verifies the other's files.

:func:`seal_header` seals a body given as pieces (``utils/msgpack.py``
``msgpack_pieces``) without joining them, and :func:`read_verified`
returns a view of a writable buffer, so a large checkpoint is neither
copied to be sealed nor to be unsealed.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Iterable, Union

ENVELOPE_MAGIC = b"DPX-CRC1\n"
_CRC_LEN = 4

Buffer = Union[bytes, bytearray, memoryview]


class CheckpointCorruptError(RuntimeError):
    """A checkpoint artifact failed integrity verification."""


def seal_header(pieces: Iterable[Buffer]) -> bytes:
    """The envelope header of the body that ``pieces`` concatenate to:
    ``seal(body)`` is ``seal_header([body]) + body``."""
    crc = 0
    for piece in pieces:
        crc = zlib.crc32(piece, crc)
    return ENVELOPE_MAGIC + struct.pack("<I", crc)


def is_sealed(data: Buffer) -> bool:
    return bytes(data[: len(ENVELOPE_MAGIC)]) == ENVELOPE_MAGIC


def unseal(data: Buffer, source: str = "<bytes>") -> Buffer:
    """Verify and strip the envelope; legacy (unsealed) data passes through.

    Raises :class:`CheckpointCorruptError` on a truncated envelope or a CRC
    mismatch, naming ``source`` so the fallback walk can log exactly which
    artifact was bad. The body is a view of ``data`` when ``data`` is a
    memoryview, else a copy.
    """
    if not is_sealed(data):
        return data  # pre-envelope checkpoint: loadable, unverified
    header = len(ENVELOPE_MAGIC) + _CRC_LEN
    if len(data) < header:
        raise CheckpointCorruptError(
            f"{source}: truncated integrity envelope "
            f"({len(data)} bytes < {header}-byte header)"
        )
    (expect,) = struct.unpack_from("<I", data, len(ENVELOPE_MAGIC))
    body = data[header:]
    actual = zlib.crc32(body)
    if actual != expect:
        raise CheckpointCorruptError(
            f"{source}: checksum mismatch (stored crc32={expect:#010x}, "
            f"computed {actual:#010x}, body {len(body)} bytes) — torn or "
            f"bit-flipped write"
        )
    return body


def read_verified(path: str) -> memoryview:
    """Read ``path`` into a writable buffer and return its verified body
    (legacy files pass through), as a view."""
    buf = bytearray(os.path.getsize(path))
    with open(path, "rb") as f:
        n = f.readinto(buf)
    return unseal(memoryview(buf)[:n], source=path)
