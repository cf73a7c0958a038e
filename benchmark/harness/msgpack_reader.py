"""A reader of the msgpack subset that flax's serializer writes.

A frozen copy of ``unpackb`` from the port's ``utils/msgpack_lite.py``
(multimodal_seq2seq_gscan_tpu_torch at commit cacbdcd): maps, arrays, str,
bin, int, float, bool, nil and ext type 1, flax's ndarray record, whose
payload is itself msgpack ``[shape, dtype-name, raw C-order bytes]``.
"""

import struct
from typing import Any, Tuple

import numpy as np

_NDARRAY_EXT = 1


class MsgpackError(ValueError):
    pass


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object that spans all of ``data``."""
    value, end = _decode(memoryview(data), 0)
    if end != len(data):
        raise MsgpackError("{} trailing bytes".format(len(data) - end))
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
    if b <= 0x7f:
        return b, pos
    if b >= 0xe0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8f:
        return _map(buf, pos, b & 0x0f)
    if 0x90 <= b <= 0x9f:
        return _array(buf, pos, b & 0x0f)
    if 0xa0 <= b <= 0xbf:
        raw, pos = _take(buf, pos, b & 0x1f)
        return bytes(raw).decode("utf-8"), pos
    if b == 0xc0:
        return None, pos
    if b == 0xc2:
        return False, pos
    if b == 0xc3:
        return True, pos
    if b in (0xc4, 0xc5, 0xc6):
        n, pos = _unpack({0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}[b], buf, pos)
        raw, pos = _take(buf, pos, n)
        return bytes(raw), pos
    if b in (0xc7, 0xc8, 0xc9):
        n, pos = _unpack({0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}[b], buf, pos)
        code, pos = _unpack(">b", buf, pos)
        raw, pos = _take(buf, pos, n)
        return _ext(code, raw), pos
    if b == 0xca:
        return _unpack(">f", buf, pos)
    if b == 0xcb:
        return _unpack(">d", buf, pos)
    if 0xcc <= b <= 0xd3:
        fmt = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
               0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}[b]
        return _unpack(fmt, buf, pos)
    if 0xd4 <= b <= 0xd8:
        code, pos = _unpack(">b", buf, pos)
        raw, pos = _take(buf, pos, 1 << (b - 0xd4))
        return _ext(code, raw), pos
    if b in (0xd9, 0xda, 0xdb):
        n, pos = _unpack({0xd9: ">B", 0xda: ">H", 0xdb: ">I"}[b], buf, pos)
        raw, pos = _take(buf, pos, n)
        return bytes(raw).decode("utf-8"), pos
    if b in (0xdc, 0xdd):
        n, pos = _unpack(">H" if b == 0xdc else ">I", buf, pos)
        return _array(buf, pos, n)
    if b in (0xde, 0xdf):
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
