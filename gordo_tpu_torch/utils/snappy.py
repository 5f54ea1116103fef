"""
Snappy's raw block format in Python, for parquet pages: the card's
machine has no snappy binding.

A block is the uncompressed length as a little-endian base-128 varint,
then elements, each a tag byte whose low two bits name it:

- ``00``: a literal; its length less one is the tag's upper six bits,
  or, when those read 60-63, the 1-4 little-endian bytes that follow;
- ``01``: a copy of 4-11 bytes at an 11-bit offset (three offset bits
  in the tag, eight in the next byte);
- ``10`` and ``11``: a copy of 1-64 bytes at a 16- or 32-bit
  little-endian offset.

A copy reaches back ``offset`` bytes into what is already written and
may overlap its own output (offset below length repeats a pattern).
:func:`decompress` writes into a preallocated ``bytearray`` by slices,
one step an element. :func:`compress` writes literals only: a valid
block that any reader takes, as large as its input. The port writes
parquet on a request's path, where a match search costs more than the
bytes it would save on float columns.

>>> decompress(b"\\x0b\\x08abc\\x11\\x03")  # 11 bytes: a literal, then 8 copied from 3 back
b'abcabcabcab'
>>> decompress(compress(b"x" * 70000)) == b"x" * 70000
True
"""

from typing import Tuple

#: bytes a literal element holds at most here (its length fits the tag's 1-4 bytes)
_LITERAL = 1 << 16
#: the most bytes a block's element gives for a byte of it (a 3-byte copy of 64)
_MAX_EXPANSION = 22


class SnappyError(ValueError):
    """A block that is malformed: a bad varint, an element that runs past
    the input or the output, or a copy from before the start."""


def _varint(buf, pos: int) -> Tuple[int, int]:
    value = shift = 0
    while True:
        if pos >= len(buf) or shift > 35:
            raise SnappyError("bad length varint")
        byte = buf[pos]
        pos += 1
        value |= (byte & 0x7F) << shift
        if byte < 0x80:
            return value, pos
        shift += 7


def _varint_bytes(value: int) -> bytes:
    out = bytearray()
    while value >= 0x80:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def decompress(data) -> bytes:
    """One raw snappy block's bytes; :class:`SnappyError` when malformed."""
    view = memoryview(data)
    length, pos = _varint(view, 0)
    if length > _MAX_EXPANSION * len(view):  # before allocating what a corrupt length asks
        raise SnappyError(f"block says {length} bytes from {len(view)}")
    out = bytearray(length)
    end, w = len(view), 0
    while pos < end:
        tag = view[pos]
        kind = tag & 3
        if kind == 0:
            size = tag >> 2
            if size < 60:
                pos += 1
            else:
                extra = size - 59
                if pos + 1 + extra > end:
                    raise SnappyError("truncated literal length")
                size = int.from_bytes(view[pos + 1: pos + 1 + extra], "little")
                pos += 1 + extra
            size += 1
            if pos + size > end or w + size > length:
                raise SnappyError("literal runs past the block")
            out[w: w + size] = view[pos: pos + size]
            pos += size
            w += size
            continue
        if kind == 1:
            if pos + 2 > end:
                raise SnappyError("truncated copy")
            size = ((tag >> 2) & 7) + 4
            offset = ((tag >> 5) << 8) | view[pos + 1]
            pos += 2
        else:
            width = 2 if kind == 2 else 4
            if pos + 1 + width > end:
                raise SnappyError("truncated copy")
            size = (tag >> 2) + 1
            offset = int.from_bytes(view[pos + 1: pos + 1 + width], "little")
            pos += 1 + width
        if offset == 0 or offset > w or w + size > length:
            raise SnappyError(f"copy of {size} bytes at offset {offset} with {w} bytes written")
        start = w - offset
        if offset >= size:
            out[w: w + size] = out[start: start + size]
        else:  # overlapping: the last ``offset`` bytes repeat
            pattern = bytes(out[start:w])
            out[w: w + size] = (pattern * (size // offset + 1))[:size]
        w += size
    if w != length:
        raise SnappyError(f"block says {length} bytes and holds {w}")
    return bytes(out)


def compress(data) -> bytes:
    """``data`` as one raw snappy block of literals (see the module's
    docstring)."""
    src = bytes(data)
    out = bytearray(_varint_bytes(len(src)))
    for start in range(0, len(src), _LITERAL):
        chunk = src[start: start + _LITERAL]
        n = len(chunk)
        if n <= 60:
            out.append((n - 1) << 2)
        else:
            width = ((n - 1).bit_length() + 7) >> 3
            out.append((59 + width) << 2)
            out += (n - 1).to_bytes(width, "little")
        out += chunk
    return bytes(out)
