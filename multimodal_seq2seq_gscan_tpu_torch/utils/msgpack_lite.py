"""A small pure-Python reader and writer of the msgpack flax's serializer uses.

Replaces ``flax.serialization.msgpack_restore`` and ``msgpack_serialize``
(used by the JAX package's ``train/checkpoint.py``) so that checkpoints load
and save without flax or msgpack. It handles the subset flax emits: maps,
arrays, str, bin, int, float, bool, nil and ext type 1, flax's ndarray
record. The payload of an ext-1 record is itself msgpack, ``[shape,
dtype-name, raw C-order bytes]``, and decodes to a numpy array. Any other
ext type raises. The writer picks the smallest encoding of each value, as
the ``msgpack`` package does, so a decoded flax file re-encodes to the same
bytes.
"""

import struct
from typing import Any, Tuple

import numpy as np

_NDARRAY_EXT = 1


class MsgpackError(ValueError):
    """The bytes are not msgpack of the subset this reader handles."""


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object that spans all of ``data``."""
    value, end = _decode(memoryview(data), 0)
    if end != len(data):
        raise MsgpackError(
            "{} trailing bytes after the msgpack object".format(len(data) - end))
    return value


def _take(buf: memoryview, pos: int, n: int) -> Tuple[memoryview, int]:
    if pos + n > len(buf):
        raise MsgpackError("truncated msgpack at byte {}".format(pos))
    return buf[pos:pos + n], pos + n


def _unpack(fmt: str, buf: memoryview, pos: int) -> Tuple[Any, int]:
    raw, pos = _take(buf, pos, struct.calcsize(fmt))
    return struct.unpack(fmt, raw)[0], pos


def _ext(code: int, payload: memoryview) -> np.ndarray:
    if code != _NDARRAY_EXT:
        raise MsgpackError("unsupported msgpack ext type {}".format(code))
    shape, dtype_name, raw = unpackb(bytes(payload))
    array = np.frombuffer(raw, dtype=np.dtype(dtype_name))
    return array.reshape(tuple(shape)).copy()


def _decode(buf: memoryview, pos: int) -> Tuple[Any, int]:
    tag, pos = _take(buf, pos, 1)
    b = tag[0]
    if b <= 0x7f:                      # positive fixint
        return b, pos
    if b >= 0xe0:                      # negative fixint
        return b - 0x100, pos
    if 0x80 <= b <= 0x8f:              # fixmap
        return _map(buf, pos, b & 0x0f)
    if 0x90 <= b <= 0x9f:              # fixarray
        return _array(buf, pos, b & 0x0f)
    if 0xa0 <= b <= 0xbf:              # fixstr
        raw, pos = _take(buf, pos, b & 0x1f)
        return bytes(raw).decode("utf-8"), pos
    if b == 0xc0:
        return None, pos
    if b == 0xc2:
        return False, pos
    if b == 0xc3:
        return True, pos
    if b in (0xc4, 0xc5, 0xc6):        # bin 8/16/32
        n, pos = _unpack({0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}[b], buf, pos)
        raw, pos = _take(buf, pos, n)
        return bytes(raw), pos
    if b in (0xc7, 0xc8, 0xc9):        # ext 8/16/32
        n, pos = _unpack({0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}[b], buf, pos)
        code, pos = _unpack(">b", buf, pos)
        raw, pos = _take(buf, pos, n)
        return _ext(code, raw), pos
    if b == 0xca:
        return _unpack(">f", buf, pos)
    if b == 0xcb:
        return _unpack(">d", buf, pos)
    if 0xcc <= b <= 0xd3:              # uint/int 8..64
        fmt = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
               0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}[b]
        return _unpack(fmt, buf, pos)
    if 0xd4 <= b <= 0xd8:              # fixext 1/2/4/8/16
        code, pos = _unpack(">b", buf, pos)
        raw, pos = _take(buf, pos, 1 << (b - 0xd4))
        return _ext(code, raw), pos
    if b in (0xd9, 0xda, 0xdb):        # str 8/16/32
        n, pos = _unpack({0xd9: ">B", 0xda: ">H", 0xdb: ">I"}[b], buf, pos)
        raw, pos = _take(buf, pos, n)
        return bytes(raw).decode("utf-8"), pos
    if b in (0xdc, 0xdd):              # array 16/32
        n, pos = _unpack(">H" if b == 0xdc else ">I", buf, pos)
        return _array(buf, pos, n)
    if b in (0xde, 0xdf):              # map 16/32
        n, pos = _unpack(">H" if b == 0xde else ">I", buf, pos)
        return _map(buf, pos, n)
    raise MsgpackError("unsupported msgpack type byte 0x{:02x}".format(b))


def _array(buf: memoryview, pos: int, n: int) -> Tuple[list, int]:
    items = []
    for _ in range(n):
        item, pos = _decode(buf, pos)
        items.append(item)
    return items, pos


def _map(buf: memoryview, pos: int, n: int) -> Tuple[dict, int]:
    out = {}
    for _ in range(n):
        key, pos = _decode(buf, pos)
        value, pos = _decode(buf, pos)
        out[key] = value
    return out, pos


def packb(value: Any) -> bytes:
    """Encode ``value`` (dicts with str keys, lists and tuples, str, bytes,
    int, float, bool, None and numpy arrays or scalars, the last two as
    ext-1 ndarray records) as msgpack."""
    out = bytearray()
    _encode(value, out)
    return bytes(out)


def _sized(out: bytearray, n: int, fix_base, fix_max: int, codes):
    """The header of a str / bin / array / map / ext of length ``n``:
    ``fix_base | n`` when ``n <= fix_max``, else the first of ``codes``
    (8-, 16- and 32-bit lengths) whose length field holds ``n``."""
    if fix_base is not None and n <= fix_max:
        out.append(fix_base | n)
        return
    for code, fmt in zip(codes, (">B", ">H", ">I")):
        if code is not None and n < 1 << (8 * struct.calcsize(fmt)):
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise MsgpackError("object of length {} is too long".format(n))


def _encode(value: Any, out: bytearray):
    if value is None:
        out.append(0xc0)
    elif isinstance(value, bool):
        out.append(0xc3 if value else 0xc2)
    elif isinstance(value, int):
        _encode_int(value, out)
    elif isinstance(value, float):
        out.append(0xcb)
        out += struct.pack(">d", value)
    elif isinstance(value, str):
        raw = value.encode("utf-8")
        _sized(out, len(raw), 0xa0, 31, (0xd9, 0xda, 0xdb))
        out += raw
    elif isinstance(value, (bytes, bytearray, memoryview)):
        raw = bytes(value)
        _sized(out, len(raw), None, -1, (0xc4, 0xc5, 0xc6))
        out += raw
    elif isinstance(value, (np.ndarray, np.generic)):
        array = np.asarray(value)
        payload = packb([list(array.shape), array.dtype.name,
                         array.tobytes("C")])
        n = len(payload)
        fixext = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
        if n in fixext:
            out.append(fixext[n])
        else:
            _sized(out, n, None, -1, (0xc7, 0xc8, 0xc9))
        out += struct.pack(">b", _NDARRAY_EXT)
        out += payload
    elif isinstance(value, (list, tuple)):
        _sized(out, len(value), 0x90, 15, (None, 0xdc, 0xdd))
        for item in value:
            _encode(item, out)
    elif isinstance(value, dict):
        _sized(out, len(value), 0x80, 15, (None, 0xde, 0xdf))
        for key, item in value.items():
            _encode(key, out)
            _encode(item, out)
    else:
        raise MsgpackError("cannot encode {!r}".format(type(value)))


def _encode_int(value: int, out: bytearray):
    if 0 <= value <= 0x7f:
        out.append(value)
    elif -32 <= value < 0:
        out.append(value & 0xff)
    elif value >= 0:
        for code, fmt in ((0xcc, ">B"), (0xcd, ">H"), (0xce, ">I"),
                          (0xcf, ">Q")):
            if value < 1 << (8 * struct.calcsize(fmt)):
                out.append(code)
                out += struct.pack(fmt, value)
                return
        raise MsgpackError("int {} does not fit in 64 bits".format(value))
    else:
        for code, fmt in ((0xd0, ">b"), (0xd1, ">h"), (0xd2, ">i"),
                          (0xd3, ">q")):
            if value >= -(1 << (8 * struct.calcsize(fmt) - 1)):
                out.append(code)
                out += struct.pack(fmt, value)
                return
        raise MsgpackError("int {} does not fit in 64 bits".format(value))
