"""flax's checkpoint byte format, without ``msgpack`` or ``flax``.

``flax.serialization.to_bytes`` writes a state dict as msgpack: maps with
``str`` keys in insertion order (lists and tuples become maps keyed
``'0'``, ``'1'``, ...), Python int / float / bool / None / str / bytes as
themselves, and two extension types:

* ext 1, an ndarray: the msgpack array ``[shape, dtype name, C-order
  buffer]``;
* ext 3, a numpy scalar: the same payload for the 0-d array.

:func:`packb` writes exactly those bytes (the same encoding choices as
msgpack-python's packer: the smallest int, float64 floats, str8 / bin8
for short strings and buffers, fixext for payloads of 1, 2, 4, 8 or 16
bytes) and :func:`unpackb` reads them back. A ``torch.bfloat16`` tensor
is written as a ``'bfloat16'`` array through its ``uint16`` view, and a
``'bfloat16'`` array is read back as a ``torch.bfloat16`` tensor; other
tensors are written as their numpy arrays. Anything else raises with a
message: other extension types, maps with keys that are not ``str``, and
flax's ``__msgpack_chunked_array__`` leaves for arrays over
:data:`MAX_ARRAY_BYTES` (2**30; no flagship leaf comes near).
"""

from __future__ import annotations

import struct
from typing import Any, List

import numpy as np
import torch

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
#: flax splits larger arrays into chunks; the port writes and reads none
MAX_ARRAY_BYTES = 2 ** 30
_CHUNKED = "__msgpack_chunked_array__"


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------

def _pack_int(v: int, out: List[bytes]) -> None:
    if 0 <= v < 0x80:
        out.append(struct.pack("B", v))
    elif v >= 0:
        for code, fmt, top in ((0xcc, ">B", 0xff), (0xcd, ">H", 0xffff),
                               (0xce, ">I", 0xffffffff),
                               (0xcf, ">Q", 0xffffffffffffffff)):
            if v <= top:
                out.append(struct.pack("B", code) + struct.pack(fmt, v))
                return
        raise OverflowError("int {} does not fit msgpack's uint64".format(v))
    elif v >= -0x20:
        out.append(struct.pack("b", v))
    else:
        for code, fmt, low in ((0xd0, ">b", -0x80), (0xd1, ">h", -0x8000),
                               (0xd2, ">i", -0x80000000),
                               (0xd3, ">q", -0x8000000000000000)):
            if v >= low:
                out.append(struct.pack("B", code) + struct.pack(fmt, v))
                return
        raise OverflowError("int {} does not fit msgpack's int64".format(v))


def _pack_len(n: int, fix: int, fix_max: int, codes, out: List[bytes]):
    """A length header: ``fix | n`` up to ``fix_max`` (when ``fix`` is not
    None), then the (code, struct format, max) of ``codes`` in order."""
    if fix is not None and n <= fix_max:
        out.append(struct.pack("B", fix | n))
        return
    for code, fmt, top in codes:
        if n <= top:
            out.append(struct.pack("B", code) + struct.pack(fmt, n))
            return
    raise ValueError("length {} is beyond msgpack's limit".format(n))


_STR = ((0xd9, ">B", 0xff), (0xda, ">H", 0xffff), (0xdb, ">I", 0xffffffff))
_BIN = ((0xc4, ">B", 0xff), (0xc5, ">H", 0xffff), (0xc6, ">I", 0xffffffff))
_ARRAY = ((0xdc, ">H", 0xffff), (0xdd, ">I", 0xffffffff))
_MAP = ((0xde, ">H", 0xffff), (0xdf, ">I", 0xffffffff))
_FIXEXT = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
_EXT = ((0xc7, ">B", 0xff), (0xc8, ">H", 0xffff), (0xc9, ">I", 0xffffffff))


def _pack_str(s: str, out: List[bytes]) -> None:
    data = s.encode("utf-8")
    _pack_len(len(data), 0xa0, 31, _STR, out)
    out.append(data)


def _pack_bin(data: bytes, out: List[bytes]) -> None:
    _pack_len(len(data), None, 0, _BIN, out)
    out.append(data)


def _array_payload(arr) -> bytes:
    """msgpack of ``[shape, dtype name, C-order buffer]`` (flax's
    ``_ndarray_to_bytes``)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return _payload(tuple(t.shape), "bfloat16",
                            t.view(torch.uint16).numpy().tobytes("C"))
        arr = t.numpy()
    if arr.dtype.hasobject or arr.dtype.names is not None:
        raise ValueError("object and structured dtypes are not "
                         "serialisable ({})".format(arr.dtype))
    return _payload(arr.shape, arr.dtype.name, arr.tobytes("C"))


def _payload(shape, name: str, buf: bytes) -> bytes:
    if len(buf) > MAX_ARRAY_BYTES:
        raise ValueError(
            "an array of {} bytes: flax would write it as chunks "
            "({}), which this codec does not support".format(len(buf),
                                                             _CHUNKED))
    out: List[bytes] = []
    _pack_len(3, 0x90, 15, _ARRAY, out)
    _pack_len(len(shape), 0x90, 15, _ARRAY, out)
    for d in shape:
        _pack_int(int(d), out)
    _pack_str(name, out)
    _pack_bin(buf, out)
    return b"".join(out)


def _pack_ext(code: int, data: bytes, out: List[bytes]) -> None:
    n = len(data)
    if n in _FIXEXT:
        out.append(struct.pack("Bb", _FIXEXT[n], code))
    else:
        _pack_len(n, None, 0, _EXT, out)
        out.append(struct.pack("b", code))
    out.append(data)


def _pack(obj: Any, out: List[bytes], path: str) -> None:
    t = type(obj)
    if obj is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if obj else b"\xc2")
    elif t is int:
        _pack_int(obj, out)
    elif t is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif t is str:
        _pack_str(obj, out)
    elif t is bytes:
        _pack_bin(obj, out)
    elif t is dict:
        _pack_len(len(obj), 0x80, 15, _MAP, out)
        for k, v in obj.items():
            if type(k) is not str:
                raise TypeError("{}: map key {!r} is not a str".format(
                    path or "/", k))
            _pack_str(k, out)
            _pack(v, out, path + "/" + k)
    elif t in (list, tuple):                 # flax: {'0': x0, '1': x1, ...}
        _pack(dict((str(i), v) for i, v in enumerate(obj)), out, path)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _pack_ext(EXT_NDARRAY, _array_payload(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, _array_payload(np.asarray(obj)), out)
    else:
        raise TypeError("{}: cannot serialise {}".format(path or "/", t))


def packb(tree: Any) -> bytes:
    """The bytes ``flax.serialization.to_bytes(tree)`` gives for a tree of
    dicts, lists, Python scalars, numpy arrays and scalars (and torch
    tensors, written as their arrays)."""
    out: List[bytes] = []
    _pack(tree, out, "")
    return b"".join(out)


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, data):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data at byte {}".format(
                self.pos))
        view = self.data[self.pos:self.pos + n]
        self.pos += n
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


# code -> (kind, struct format of the length or value)
_FIXED = {0xcc: ("int", ">B"), 0xcd: ("int", ">H"), 0xce: ("int", ">I"),
          0xcf: ("int", ">Q"), 0xd0: ("int", ">b"), 0xd1: ("int", ">h"),
          0xd2: ("int", ">i"), 0xd3: ("int", ">q"), 0xca: ("float", ">f"),
          0xcb: ("float", ">d"), 0xd9: ("str", ">B"), 0xda: ("str", ">H"),
          0xdb: ("str", ">I"), 0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"),
          0xc6: ("bin", ">I"), 0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
          0xde: ("map", ">H"), 0xdf: ("map", ">I"), 0xc7: ("ext", ">B"),
          0xc8: ("ext", ">H"), 0xc9: ("ext", ">I")}
_FIXEXT_LEN = {v: k for k, v in _FIXEXT.items()}


def _unpack(r: _Reader, path: str, ext: bool = True) -> Any:
    code = r.unpack("B")
    if code <= 0x7f:
        return code
    if code >= 0xe0:
        return code - 0x100
    if 0x80 <= code <= 0x8f:
        return _unpack_map(r, code & 0x0f, path)
    if 0x90 <= code <= 0x9f:
        return [_unpack(r, path, ext) for _ in range(code & 0x0f)]
    if 0xa0 <= code <= 0xbf:
        return str(r.take(code & 0x1f), "utf-8")
    if code == 0xc0:
        return None
    if code in (0xc2, 0xc3):
        return code == 0xc3
    if code in _FIXEXT_LEN:
        return _unpack_ext(r, _FIXEXT_LEN[code], path, ext)
    if code not in _FIXED:
        raise ValueError("{}: msgpack type byte 0x{:02x} is not supported"
                         .format(path or "/", code))
    kind, fmt = _FIXED[code]
    value = r.unpack(fmt)
    if kind in ("int", "float"):
        return value
    if kind == "str":
        return str(r.take(value), "utf-8")
    if kind == "bin":
        return bytes(r.take(value))
    if kind == "array":
        return [_unpack(r, path, ext) for _ in range(value)]
    if kind == "map":
        return _unpack_map(r, value, path)
    return _unpack_ext(r, value, path, ext)


def _unpack_map(r: _Reader, n: int, path: str) -> dict:
    out = {}
    for _ in range(n):
        key = _unpack(r, path, ext=False)
        if type(key) is not str:
            raise ValueError("{}: map key {!r} is not a str".format(
                path or "/", key))
        out[key] = _unpack(r, path + "/" + key)
    if _CHUNKED in out:
        raise ValueError(
            "{}: a chunked array ({}, flax's form for arrays over {} bytes)"
            " is not supported".format(path or "/", _CHUNKED,
                                       MAX_ARRAY_BYTES))
    return out


def _unpack_ext(r: _Reader, n: int, path: str, allowed: bool):
    code = r.unpack("b")
    data = r.take(n)
    if not allowed or code not in (EXT_NDARRAY, EXT_NPSCALAR):
        raise ValueError("{}: msgpack extension type {} is not supported "
                         "(1: ndarray, 3: numpy scalar)".format(path or "/",
                                                                code))
    sub = _Reader(data)
    fields = _unpack(sub, path, ext=False)
    if not (isinstance(fields, list) and len(fields) == 3
            and isinstance(fields[0], list) and isinstance(fields[2], bytes)):
        raise ValueError("{}: not an ndarray payload".format(path or "/"))
    shape, name, buf = fields
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        flat = np.frombuffer(buf, dtype=np.uint16).copy()
        arr = torch.from_numpy(flat).view(torch.bfloat16).reshape(shape)
        return arr
    dtype = np.dtype(name)
    if dtype.hasobject or dtype.names is not None:
        raise ValueError("{}: dtype {} is not supported".format(path or "/",
                                                                name))
    arr = np.frombuffer(buf, dtype=dtype).copy().reshape(shape)
    return arr[()] if code == EXT_NPSCALAR else arr


def unpackb(data: bytes) -> Any:
    """The tree ``flax.serialization.msgpack_restore(data)`` gives: dicts,
    lists, Python scalars, numpy arrays (``torch.bfloat16`` tensors for
    bfloat16 leaves) and numpy scalars."""
    r = _Reader(data)
    out = _unpack(r, "")
    if r.pos != len(r.data):
        raise ValueError("{} bytes after the msgpack object".format(
            len(r.data) - r.pos))
    return out
