"""A pure-Python MessagePack codec for the values an index's metadata holds:
``None``, ``bool``, ``int``, ``float``, ``str``, ``list``/``tuple`` and
``dict`` with ``str`` keys, nested freely.

``packb`` writes the bytes ``msgpack.packb`` writes with its defaults:
the smallest integer encoding (unsigned formats for values ≥ 0), float64,
fixstr/str8/str16/str32, tuples as arrays, and dicts in their iteration
order. ``unpackb`` reads whatever ``msgpack.packb`` writes for such values
(float32 too) and returns lists for arrays. Any other type raises
``TypeError``: nothing is coerced. An integer outside [−2⁶³, 2⁶⁴) raises
``OverflowError``, as msgpack's does.
"""
from __future__ import annotations

import struct
from typing import Any, List, Tuple

__all__ = ["packb", "unpackb"]


def packb(obj: Any) -> bytes:
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


def _length(out: List[bytes], n: int, fix: int, fix_max: int,
            formats: Tuple[Tuple[int, int, str], ...]) -> None:
    """The header of a str, array or map of ``n`` items: the fix format
    below ``fix_max``, else the first (tag, limit, struct code) that fits."""
    if n < fix_max:
        out.append(bytes((fix | n,)))
        return
    for tag, limit, code in formats:
        if n < limit:
            out.append(bytes((tag,)) + struct.pack(code, n))
            return
    raise ValueError(f"msgpack cannot hold {n} items")


_STR = ((0xD9, 1 << 8, ">B"), (0xDA, 1 << 16, ">H"), (0xDB, 1 << 32, ">I"))
_ARRAY = ((0xDC, 1 << 16, ">H"), (0xDD, 1 << 32, ">I"))
_MAP = ((0xDE, 1 << 16, ">H"), (0xDF, 1 << 32, ">I"))


def _pack_int(x: int, out: List[bytes]) -> None:
    if 0 <= x < 0x80:
        out.append(bytes((x,)))
    elif -32 <= x < 0:
        out.append(struct.pack(">b", x))
    elif x >= 0:
        for tag, code in ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"),
                          (0xCF, ">Q")):
            if x < 1 << (8 * struct.calcsize(code)):
                out.append(bytes((tag,)) + struct.pack(code, x))
                return
        raise OverflowError("Integer value out of range")
    else:
        for tag, code in ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"),
                          (0xD3, ">q")):
            if x >= -(1 << (8 * struct.calcsize(code) - 1)):
                out.append(bytes((tag,)) + struct.pack(code, x))
                return
        raise OverflowError("Integer value out of range")


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _length(out, len(raw), 0xA0, 32, _STR)
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        _length(out, len(obj), 0x90, 16, _ARRAY)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _length(out, len(obj), 0x80, 16, _MAP)
        for key, value in obj.items():
            if not isinstance(key, str):
                raise TypeError(f"map keys must be str, got "
                                f"{type(key).__name__!r}")
            _pack(key, out)
            _pack(value, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


# the fixed-size formats (tag → struct code) and the sized ones (tag →
# (struct code of the length, kind))
_FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
          0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_SIZED = {0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
          0xDC: (">H", "array"), 0xDD: (">I", "array"),
          0xDE: (">H", "map"), 0xDF: (">I", "map")}


def unpackb(data: bytes) -> Any:
    data = bytes(data)
    obj, pos = _unpack(data, 0)
    if pos != len(data):
        raise ValueError(f"{len(data) - pos} bytes of extra data")
    return obj


def _take(data: bytes, pos: int, n: int) -> Tuple[bytes, int]:
    if pos + n > len(data):
        raise ValueError("truncated msgpack data")
    return data[pos:pos + n], pos + n


def _unpack(data: bytes, pos: int) -> Tuple[Any, int]:
    raw, pos = _take(data, pos, 1)
    tag = raw[0]
    if tag < 0x80:
        return tag, pos
    if tag >= 0xE0:
        return tag - 0x100, pos
    if tag == 0xC0:
        return None, pos
    if tag in (0xC2, 0xC3):
        return tag == 0xC3, pos
    if tag in _FIXED:
        code = _FIXED[tag]
        raw, pos = _take(data, pos, struct.calcsize(code))
        return struct.unpack(code, raw)[0], pos
    if 0xA0 <= tag < 0xC0:
        n, kind = tag & 0x1F, "str"
    elif 0x90 <= tag < 0xA0:
        n, kind = tag & 0x0F, "array"
    elif 0x80 <= tag < 0x90:
        n, kind = tag & 0x0F, "map"
    elif tag in _SIZED:
        code, kind = _SIZED[tag]
        raw, pos = _take(data, pos, struct.calcsize(code))
        n = struct.unpack(code, raw)[0]
    else:
        raise ValueError(f"unsupported msgpack type 0x{tag:02x}")
    if kind == "str":
        raw, pos = _take(data, pos, n)
        return raw.decode("utf-8"), pos
    if kind == "array":
        items = []
        for _ in range(n):
            item, pos = _unpack(data, pos)
            items.append(item)
        return items, pos
    out = {}
    for _ in range(n):
        key, pos = _unpack(data, pos)
        if not isinstance(key, str):
            raise ValueError(f"map key of type {type(key).__name__!r}")
        out[key], pos = _unpack(data, pos)
    return out, pos
