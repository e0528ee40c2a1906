"""Flax msgpack variable files (counterpart of the JAX package's
``utils/serialization.py``), through the port's own codec.

``convert_checkpoint --kind i3d`` (the JAX package's
``scripts/convert_checkpoint.py``, or the port's
``anomaly_detection_on_video_tpu_torch.scripts.convert_checkpoint``, which
writes the same bytes through this codec) and the JAX package write I3D
weights as flax's ``msgpack_serialize`` of a ``{"params", "batch_stats"}``
tree. The port reads and writes that layout without the ``msgpack`` or
``flax`` packages, which the card's machine lacks. The codec covers what
flax writes:

- maps with str keys, str, bin, int, float, bool, nil and arrays;
- ext type 1, an ndarray: the msgpack of ``(shape, dtype name, C-order
  bytes)`` (flax's ``_ndarray_to_bytes``); ext type 3, a numpy scalar in
  the same layout;
- ``__msgpack_chunked_array__`` maps, which flax writes for a leaf over
  ``MAX_CHUNK_SIZE`` bytes: reassembled on read; ``save_variables``
  refuses such a leaf.

Any other ext code raises ValueError naming it. Arrays come back as
read-only numpy arrays over the file's bytes (no copy). ``save_variables``
writes the bytes flax writes for the same tree: keys sorted, as flax's
tree map orders them, and the smallest msgpack format for every value.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, List, Tuple

import numpy as np

MAX_CHUNK_SIZE = 2 ** 30  # bytes: flax chunks a leaf above this
EXT_NDARRAY, EXT_NPSCALAR = 1, 3
CHUNKED = "__msgpack_chunked_array__"


# ------------------------------------------------------------------ decode

_FIXED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i",
          0xd3: ">q", 0xca: ">f", 0xcb: ">d"}
_LENGTH = {1: ">B", 2: ">H", 4: ">I"}


class _Reader:
    """A msgpack decoder over one memoryview. ``bin_views`` returns bin
    payloads as memoryview slices (an ndarray's bytes) instead of copies."""

    def __init__(self, view: memoryview, bin_views: bool = False):
        self.view = view
        self.pos = 0
        self.bin_views = bin_views

    def _take(self, n: int) -> memoryview:
        start = self.pos
        self.pos += n
        if self.pos > len(self.view):
            raise ValueError(f"msgpack data truncated at byte {start} (needs {n} more)")
        return self.view[start:self.pos]

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        b = self._take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self._map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self._array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return self._str(b & 0x1f)
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _FIXED:
            return self._unpack(_FIXED[b])
        if 0xc4 <= b <= 0xc6:  # bin 8 / 16 / 32
            data = self._take(self._unpack(_LENGTH[1 << (b - 0xc4)]))
            return data if self.bin_views else bytes(data)
        if 0xd9 <= b <= 0xdb:  # str 8 / 16 / 32
            return self._str(self._unpack(_LENGTH[1 << (b - 0xd9)]))
        if b in (0xdc, 0xdd):
            return self._array(self._unpack(">H" if b == 0xdc else ">I"))
        if b in (0xde, 0xdf):
            return self._map(self._unpack(">H" if b == 0xde else ">I"))
        if 0xd4 <= b <= 0xd8:  # fixext 1 / 2 / 4 / 8 / 16
            return self._ext(1 << (b - 0xd4))
        if 0xc7 <= b <= 0xc9:  # ext 8 / 16 / 32
            return self._ext(self._unpack(_LENGTH[1 << (b - 0xc7)]))
        raise ValueError(f"msgpack: byte 0x{b:02x} at {self.pos - 1} starts no value")

    def _str(self, n: int) -> str:
        return str(self._take(n), "utf-8")

    def _array(self, n: int) -> List[Any]:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        if CHUNKED in out:
            return _unchunk(out)
        return out

    def _ext(self, n: int) -> Any:
        code = self._unpack(">b")
        data = self._take(n)
        if code == EXT_NDARRAY:
            return _ndarray_from_bytes(data)
        if code == EXT_NPSCALAR:
            return _ndarray_from_bytes(data)[()]
        raise ValueError(f"msgpack ext type {code} is not one flax writes for variables "
                         f"(the codec reads ext {EXT_NDARRAY}, ndarray, and ext {EXT_NPSCALAR}, "
                         "numpy scalar)")


def _ndarray_from_bytes(data: memoryview) -> np.ndarray:
    shape, dtype_name, buffer = _Reader(data, bin_views=True).read()
    if dtype_name == "bfloat16":
        raise ValueError("a bfloat16 leaf: numpy has no bfloat16 dtype; save the variables as "
                         "float32")
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape)


def _unchunk(node: Dict[str, Any]) -> np.ndarray:
    """A ``__msgpack_chunked_array__`` map -> its array (flax's ``_unchunk``)."""
    shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
    chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
    return np.concatenate(chunks).reshape(shape)


def msgpack_restore(data: bytes) -> Any:
    """msgpack bytes in flax's layout -> the tree (dicts, lists, numpy
    arrays and scalars, Python values)."""
    reader = _Reader(memoryview(data))
    tree = reader.read()
    if reader.pos != len(data):
        raise ValueError(f"msgpack: {len(data) - reader.pos} bytes after the value")
    return tree


# ------------------------------------------------------------------ encode

def _header(n: int, fix: int, fix_max: int, wide: Tuple[Tuple[int, int, str], ...]) -> bytes:
    """The smallest header for a length ``n``: a fix byte ``fix | n`` up to
    ``fix_max``, else the first (byte, max, struct format) that fits."""
    if fix is not None and n <= fix_max:
        return bytes((fix | n,))
    for byte, limit, fmt in wide:
        if n <= limit:
            return bytes((byte,)) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: length {n} too large")


_STR = ((0xd9, 0xff, ">B"), (0xda, 0xffff, ">H"), (0xdb, 0xffffffff, ">I"))
_BIN = ((0xc4, 0xff, ">B"), (0xc5, 0xffff, ">H"), (0xc6, 0xffffffff, ">I"))
_ARRAY = ((0xdc, 0xffff, ">H"), (0xdd, 0xffffffff, ">I"))
_MAP = ((0xde, 0xffff, ">H"), (0xdf, 0xffffffff, ">I"))
_EXT = ((0xc7, 0xff, ">B"), (0xc8, 0xffff, ">H"), (0xc9, 0xffffffff, ">I"))
_FIXEXT = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}


def _int(n: int) -> bytes:
    """msgpack's smallest integer format, as msgpack-python picks it."""
    if 0 <= n < 0x80:
        return bytes((n,))
    if -0x20 <= n < 0:
        return struct.pack(">b", n)
    for byte, low, high, fmt in ((0xcc, 0, 0xff, ">B"), (0xd0, -0x80, -1, ">b"),
                                 (0xcd, 0, 0xffff, ">H"), (0xd1, -0x8000, -1, ">h"),
                                 (0xce, 0, 0xffffffff, ">I"), (0xd2, -0x80000000, -1, ">i"),
                                 (0xcf, 0, 0xffffffffffffffff, ">Q"),
                                 (0xd3, -0x8000000000000000, -1, ">q")):
        if low <= n <= high:
            return bytes((byte,)) + struct.pack(fmt, n)
    raise OverflowError(f"msgpack: integer {n} out of range")


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif type(obj) is int:
        out.append(_int(obj))
    elif type(obj) is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif type(obj) is str:
        data = obj.encode("utf-8")
        out += [_header(len(data), 0xa0, 0x1f, _STR), data]
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        out += [_header(len(data), None, 0, _BIN), data]
    elif isinstance(obj, dict):
        out.append(_header(len(obj), 0x80, 0x0f, _MAP))
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    elif isinstance(obj, (list, tuple)):
        out.append(_header(len(obj), 0x90, 0x0f, _ARRAY))
        for value in obj:
            _pack(value, out)
    elif isinstance(obj, np.ndarray):
        _pack_ext(EXT_NDARRAY, _ndarray_to_bytes(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, _ndarray_to_bytes(np.asarray(obj)), out)
    else:
        raise TypeError(f"msgpack: cannot serialize {type(obj).__name__!r}")


def _pack_ext(code: int, data: bytes, out: List[bytes]) -> None:
    if len(data) in _FIXEXT:
        out.append(bytes((_FIXEXT[len(data)],)))
    else:
        out.append(_header(len(data), None, 0, _EXT))
    out += [struct.pack(">b", code), data]


def _ndarray_to_bytes(arr: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``: the msgpack of (shape, dtype name,
    C-order bytes)."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    out: List[bytes] = []
    _pack([list(arr.shape), arr.dtype.name, arr.tobytes("C")], out)
    return b"".join(out)


def _prepare(tree: Any, path: str = "") -> Any:
    """The tree as flax packs it: dict keys sorted (its tree map's order).
    A leaf over ``MAX_CHUNK_SIZE`` raises: flax would chunk it, and no I3D
    tree has one."""
    if isinstance(tree, dict):
        return {key: _prepare(tree[key], f"{path}/{key}") for key in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_prepare(value, f"{path}/{i}") for i, value in enumerate(tree))
    if isinstance(tree, np.ndarray) and tree.nbytes > MAX_CHUNK_SIZE:
        raise ValueError(f"leaf {path or '/'} holds {tree.nbytes} bytes, over MAX_CHUNK_SIZE "
                         f"({MAX_CHUNK_SIZE}): the codec writes no {CHUNKED} maps")
    return tree


def msgpack_serialize(tree: Any) -> bytes:
    """A tree of dicts, lists, numpy arrays and Python values -> the bytes
    flax's ``msgpack_serialize`` writes for it."""
    out: List[bytes] = []
    _pack(_prepare(tree), out)
    return b"".join(out)


def save_variables(path: str, variables: Dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(msgpack_serialize(variables))


def load_variables(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return msgpack_restore(f.read())
