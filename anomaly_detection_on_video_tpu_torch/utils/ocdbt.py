"""The OCDBT key-value store (tensorstore's "optionally-cooperative
distributed b-tree", the store under the JAX package's orbax checkpoints),
read and written.

It reads and writes the on-disk format that tensorstore documents ("OCDBT
on-disk format"), with no tensorstore:

- ``manifest.ocdbt`` at the database's root holds the config and the
  version tree: the newest versions inline, older ones in version tree
  nodes. Each version names the root of a b-tree.
- b-tree nodes and version tree nodes live in data files (``d/<hex>``),
  at an offset and length. Interior nodes map key ranges to children;
  leaf nodes map keys to values, which are inline or a reference (data
  file, offset, length) to bytes stored raw in a data file.
- Keys are prefix-compressed within a node, and an interior entry's
  ``subtree_common_prefix_length`` bytes are left out of every key below
  it.
- Every manifest and node file is ``magic (u32 big-endian) | length (u64)
  | version | compression (0 none, 1 zstd) | body | crc32c (u32)``; the
  CRC is checked on every read.
- A data file table lists the paths of the files a node or manifest
  refers to, relative to the base path of the file that holds it; orbax's
  root database refers into ``ocdbt.process_<n>/`` that way.

``OcdbtStore(path).list()`` returns the sorted keys of the newest version
and ``read(key)`` a value's bytes. Only the single-file manifest kind
(tensorstore's default, the one orbax writes) is read. ``OcdbtWriter``
writes a new database of one version in that kind, its b-tree one leaf.
"""

from __future__ import annotations

import os
import struct
import time
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple, Union

from . import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
VERSION_TREE_MAGIC = 0x0CDB1234
MANIFEST_FILE = "manifest.ocdbt"
# the writer's config: orbax's (tensorstore's defaults)
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4
ZSTD_LEVEL = 0  # the library's default level
_MISSING = 2**64 - 1  # the offset and length of an empty tree's root


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), the checksum of every OCDBT file."""
    c = 0xFFFFFFFF
    table = _CRC_TABLE
    for byte in data:
        c = table[(c ^ byte) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Reader:
    """Cursor over a decoded body: varints, fixed-width fields, columns."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def _need(self, n: int) -> None:
        if self.pos + n > len(self.data):
            raise ValueError(f"ocdbt: {self.what} is truncated")

    def varint(self) -> int:
        value = shift = 0
        while True:
            self._need(1)
            byte = self.data[self.pos]
            self.pos += 1
            value |= (byte & 0x7F) << shift
            if byte < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise ValueError(f"ocdbt: {self.what} holds a varint over 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def u8s(self, n: int) -> List[int]:
        self._need(n)
        out = list(self.data[self.pos:self.pos + n])
        self.pos += n
        return out

    def u64s(self, n: int) -> List[int]:
        self._need(8 * n)
        out = list(struct.unpack_from(f"<{n}Q", self.data, self.pos))
        self.pos += 8 * n
        return out

    def raw(self, n: int) -> bytes:
        self._need(n)
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def done(self) -> None:
        if self.pos != len(self.data):
            raise ValueError(f"ocdbt: {self.what} has {len(self.data) - self.pos} "
                             "trailing bytes")


def decode_file(data: bytes, magic: int, what: str) -> bytes:
    """The body of one manifest or node file, its header and CRC32C
    checked, decompressed where the file says zstd."""
    if len(data) < 18:
        raise ValueError(f"ocdbt: {what} is truncated ({len(data)} bytes)")
    got_magic, length = struct.unpack_from(">I", data)[0], struct.unpack_from("<Q", data, 4)[0]
    if got_magic != magic:
        raise ValueError(f"ocdbt: {what}: magic {got_magic:#010x}, expected {magic:#010x}")
    if length != len(data):
        raise ValueError(f"ocdbt: {what}: header length {length}, file {len(data)} bytes")
    crc = struct.unpack_from("<I", data, len(data) - 4)[0]
    if crc32c(data[:-4]) != crc:
        raise ValueError(f"ocdbt: {what}: CRC32C mismatch (the file is corrupt)")
    header = _Reader(data[12:-4], what)
    version, compression = header.varint(), header.varint()
    if version != 0:
        raise ValueError(f"ocdbt: {what}: format version {version} is not supported")
    body = data[12 + header.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body)
    raise ValueError(f"ocdbt: {what}: unknown compression format {compression}")


class Location(NamedTuple):
    path: str       # the data file, relative to the database root
    base: str       # the base path that the file's own tables are relative to
    offset: int
    length: int


class Version(NamedTuple):
    generation: int
    root_height: int
    root: Optional[Location]  # None: an empty tree
    num_keys: int
    commit_time: int


class Config(NamedTuple):
    uuid: bytes
    manifest_kind: int
    max_inline_value_bytes: int
    max_decoded_node_bytes: int
    version_tree_arity_log2: int
    compression: int


def _data_file_table(r: _Reader, base: str) -> List[Tuple[str, str]]:
    """(path, base path) of each file the table lists, ``base`` prefixed:
    paths share prefixes with the previous path; each path's first
    ``base_path_length`` bytes are the base its own tables resolve against."""
    n = r.varint()
    prefix = r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    base_len = r.varints(n)
    files, previous = [], b""
    for i in range(n):
        if i and prefix[i - 1] > len(previous):
            raise ValueError(f"ocdbt: {r.what}: a data file path prefix is out of range")
        path = (previous[:prefix[i - 1]] if i else b"") + r.raw(suffix[i])
        if base_len[i] > len(path):
            raise ValueError(f"ocdbt: {r.what}: a data file base path is out of range")
        files.append((base + path.decode(), base + path[:base_len[i]].decode()))
        previous = path
    return files


def _locations(r: _Reader, files: List[Tuple[str, str]], n: int) -> List[Optional[Location]]:
    ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
    out = []
    for i, o, n_bytes in zip(ids, offsets, lengths):
        if o == _MISSING and n_bytes == _MISSING:
            out.append(None)
            continue
        if i >= len(files):
            raise ValueError(f"ocdbt: {r.what}: data file {i} of a table of {len(files)}")
        out.append(Location(files[i][0], files[i][1], o, n_bytes))
    return out


def _keys(r: _Reader, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    prefix = r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    common = r.varints(n) if interior else [0] * n
    keys, previous = [], b""
    for i in range(n):
        if i and prefix[i - 1] > len(previous):
            raise ValueError(f"ocdbt: {r.what}: a key prefix is out of range")
        key = (previous[:prefix[i - 1]] if i else b"") + r.raw(suffix[i])
        keys.append(key)
        previous = key
    return keys, common


class OcdbtStore:
    """The newest version of the OCDBT database at ``path`` (a directory
    holding ``manifest.ocdbt``), read only."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        self._index: Optional[Dict[bytes, Tuple[Optional[Location], Optional[bytes], int]]] = None
        self.config, versions, nodes = self._read_manifest()
        self.versions = versions + [v for ref in nodes for v in self._version_node(*ref)]
        self.versions.sort(key=lambda v: v.generation)
        self.latest = self.versions[-1] if self.versions else None

    # -- files

    def _read(self, path: str, offset: int = 0, length: Optional[int] = None) -> bytes:
        full = os.path.join(self.path, path)
        with open(full, "rb") as f:
            if length is None:
                return f.read()
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise ValueError(f"ocdbt: {path} holds {len(data)} bytes at offset {offset}, "
                             f"expected {length}")
        return data

    def _node(self, loc: Location, magic: int, what: str) -> bytes:
        return decode_file(self._read(loc.path, loc.offset, loc.length), magic,
                           f"{what} at {loc.path}:{loc.offset}")

    # -- manifest and version tree

    def _read_manifest(self):
        what = os.path.join(self.path, MANIFEST_FILE)
        if not os.path.exists(what):
            raise FileNotFoundError(f"ocdbt: no {MANIFEST_FILE} in {self.path}")
        r = _Reader(decode_file(self._read(MANIFEST_FILE), MANIFEST_MAGIC, what), what)
        uuid = r.raw(16)
        kind, max_inline, max_node = r.varint(), r.varint(), r.varint()
        arity, compression = r.u8s(1)[0], r.varint()
        if compression == 1:
            r.raw(4)  # the zstd level, an int32
        elif compression != 0:
            raise ValueError(f"ocdbt: {what}: unknown node compression {compression}")
        config = Config(uuid, kind, max_inline, max_node, arity, compression)
        if kind != 0:
            raise ValueError(f"ocdbt: {what}: manifest kind {kind} (numbered manifests) is not "
                             "supported; only the single-file manifest is read")
        files = _data_file_table(r, "")
        versions = self._version_entries(r, files)
        n = r.varint()
        generations = r.varints(n)
        locations = _locations(r, files, n)
        r.varints(n)  # num_generations
        r.u64s(n)     # commit_time
        heights = r.u8s(n)
        r.done()
        return config, versions, list(zip(locations, heights, generations))

    def _version_entries(self, r: _Reader, files) -> List[Version]:
        n = r.varint()
        generations = r.varints(n)
        heights = r.u8s(n)
        roots = _locations(r, files, n)
        num_keys = r.varints(n)
        r.varints(n)  # num_tree_bytes
        r.varints(n)  # num_indirect_value_bytes
        times = r.u64s(n)
        return [Version(*v) for v in zip(generations, heights, roots, num_keys, times)]

    def _version_node(self, loc: Location, height: int, generation: int) -> List[Version]:
        what = f"version tree node at {loc.path}:{loc.offset}"
        r = _Reader(self._node(loc, VERSION_TREE_MAGIC, "version tree node"), what)
        arity, got_height = r.u8s(2)
        if got_height != height:
            raise ValueError(f"ocdbt: {what}: height {got_height}, expected {height}")
        files = _data_file_table(r, loc.base)
        if height == 0:
            versions = self._version_entries(r, files)
            r.done()
            return versions
        n = r.varint()
        generations = r.varints(n)
        children = _locations(r, files, n)
        r.varints(n)  # num_generations
        r.u64s(n)     # commit_time
        r.done()
        return [v for child, g in zip(children, generations)
                for v in self._version_node(child, height - 1, g)]

    # -- b-tree

    def _entries(self, loc: Location, height: int, prefix: bytes) -> Iterator[
            Tuple[bytes, Optional[Location], Optional[bytes], int]]:
        """(key, indirect location or None, inline value or None, length)
        of every entry below the node at ``loc``, in key order."""
        what = f"b-tree node at {loc.path}:{loc.offset}"
        r = _Reader(self._node(loc, BTREE_MAGIC, "b-tree node"), what)
        got_height = r.u8s(1)[0]
        if got_height != height:
            raise ValueError(f"ocdbt: {what}: height {got_height}, expected {height}")
        files = _data_file_table(r, loc.base)
        n = r.varint()
        keys, common = _keys(r, n, interior=height > 0)
        if height > 0:
            children = _locations(r, files, n)
            r.varints(3 * n)  # statistics: num_keys, num_tree_bytes, num_indirect_value_bytes
            r.done()
            for key, child, c in zip(keys, children, common):
                if c > len(key):
                    raise ValueError(f"ocdbt: {what}: a subtree prefix is out of range")
                yield from self._entries(child, height - 1, prefix + key[:c])
            return
        lengths = r.varints(n)
        kinds = r.varints(n)
        indirect = [i for i, k in enumerate(kinds) if k == 1]
        if any(k not in (0, 1) for k in kinds):
            raise ValueError(f"ocdbt: {what}: unknown value kind")
        ids, offsets = r.varints(len(indirect)), r.varints(len(indirect))
        refs = {}
        for i, file_id, offset in zip(indirect, ids, offsets):
            if file_id >= len(files):
                raise ValueError(f"ocdbt: {what}: data file {file_id} of a table of {len(files)}")
            refs[i] = Location(files[file_id][0], files[file_id][1], offset, lengths[i])
        for i, key in enumerate(keys):
            if i in refs:
                yield prefix + key, refs[i], None, lengths[i]
            else:
                yield prefix + key, None, r.raw(lengths[i]), lengths[i]
        r.done()

    def _build_index(self):
        if self._index is None:
            index = {}
            v = self.latest
            if v is not None and v.root is not None:
                for key, loc, value, length in self._entries(v.root, v.root_height, b""):
                    index[key] = (loc, value, length)
            self._index = index
        return self._index

    def list(self) -> List[bytes]:
        """Every key of the newest version, sorted bytewise."""
        return sorted(self._build_index())

    def read(self, key: Union[str, bytes]) -> bytes:
        """The value stored under ``key``; KeyError where there is none."""
        if isinstance(key, str):
            key = key.encode()
        try:
            loc, value, length = self._build_index()[key]
        except KeyError:
            raise KeyError(f"ocdbt: no key {key!r} in {self.path}") from None
        if loc is None:
            return value
        return self._read(loc.path, loc.offset, loc.length)


# ---------------------------------------------------------------- writing

def _varint(value: int) -> bytes:
    if value < 0:
        raise ValueError(f"ocdbt: a varint of {value}")
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _varints(values) -> bytes:
    return b"".join(_varint(v) for v in values)


def _common_prefix(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def encode_file(body: bytes, magic: int) -> bytes:
    """One manifest or node file around ``body``: ``magic | length |
    version 0 | compression 1 | zstd(body) | crc32c``."""
    body = zstd.compress(body, ZSTD_LEVEL)
    head = _varint(0) + _varint(1)
    length = 12 + len(head) + len(body) + 4
    data = struct.pack(">I", magic) + struct.pack("<Q", length) + head + body
    return data + struct.pack("<I", crc32c(data))


def _encode_data_file_table(paths: List[str]) -> bytes:
    """A table of ``paths`` (each its own base: base path length 0)."""
    raw = [p.encode() for p in paths]
    prefix = [_common_prefix(a, b) for a, b in zip(raw, raw[1:])]
    suffix = [p[c:] for p, c in zip(raw, [0] + prefix)]
    return (_varint(len(raw)) + _varints(prefix) + _varints(len(s) for s in suffix)
            + _varints(0 for _ in raw) + b"".join(suffix))


def _encode_keys(keys: List[bytes]) -> bytes:
    """A leaf's keys, each stored without its prefix shared with the one before."""
    prefix = [_common_prefix(a, b) for a, b in zip(keys, keys[1:])]
    suffix = [k[c:] for k, c in zip(keys, [0] + prefix)]
    return (_varint(len(keys)) + _varints(prefix) + _varints(len(s) for s in suffix)
            + b"".join(suffix))


class OcdbtWriter:
    """Writes one OCDBT database, generation 1, at ``path`` (a directory
    that must not hold a database yet), readable by ``OcdbtStore`` and by
    tensorstore's ``ocdbt`` driver, in the config of the JAX package's
    orbax checkpoints (``MAX_INLINE_VALUE_BYTES``,
    ``MAX_DECODED_NODE_BYTES``).

    ``put(key, value)`` stores a value: one of at most
    ``MAX_INLINE_VALUE_BYTES`` bytes stays inline in the leaf node, a
    longer one is appended raw to the database's one data file
    (``d/<32 hex digits>``) at once. ``close()`` writes the b-tree, one
    leaf node, into the same data file (a leaf past
    ``MAX_DECODED_NODE_BYTES`` raises: an orbax step of the port's models
    has about a thousand keys) and then ``manifest.ocdbt``: the config (a
    fresh uuid, zstd nodes) and the one version. As a context manager it
    closes on leaving the block, and on an exception only closes its data
    file (no manifest: no database)."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        if os.path.exists(os.path.join(self.path, MANIFEST_FILE)):
            raise FileExistsError(f"ocdbt: {self.path} already holds a database")
        os.makedirs(os.path.join(self.path, "d"), exist_ok=True)
        self.data_file = "d/" + os.urandom(16).hex()
        self._file = open(os.path.join(self.path, self.data_file), "wb")
        self._offset = 0
        # key -> (inline value, None) or (None, (offset, length))
        self._entries: Dict[bytes, Tuple[Optional[bytes], Optional[Tuple[int, int]]]] = {}

    def __enter__(self) -> "OcdbtWriter":
        return self

    def __exit__(self, kind, *_) -> None:
        if kind is None:
            self.close()
        else:
            self._file.close()

    def put(self, key: Union[str, bytes], value) -> None:
        """Store ``value`` (any C-contiguous buffer) under ``key``."""
        if isinstance(key, str):
            key = key.encode()
        if key in self._entries:
            raise KeyError(f"ocdbt: key {key!r} is written twice")
        view = memoryview(value).cast("B")
        if len(view) <= MAX_INLINE_VALUE_BYTES:
            self._entries[key] = (bytes(view), None)
            return
        self._file.write(view)
        self._entries[key] = (None, (self._offset, len(view)))
        self._offset += len(view)

    def _leaf(self) -> Tuple[int, int, int]:
        """Append the one leaf node of every entry: (its offset, its
        length, the bytes its values hold in the data file)."""
        keys = sorted(self._entries)
        values = [self._entries[k] for k in keys]
        indirect = [ref for _, ref in values if ref is not None]
        table = [self.data_file] if indirect else []
        body = (b"\x00" + _encode_data_file_table(table) + _encode_keys(keys)
                + _varints(len(v) if v is not None else ref[1] for v, ref in values)
                + _varints(0 if v is not None else 1 for v, _ in values)
                + _varints(0 for _ in indirect) + _varints(o for o, _ in indirect)
                + b"".join(v for v, _ in values if v is not None))
        if len(body) > MAX_DECODED_NODE_BYTES:
            raise ValueError(f"ocdbt: a leaf of {len(body)} bytes passes the limit of "
                             f"{MAX_DECODED_NODE_BYTES} (the writer writes no interior node)")
        node = encode_file(body, BTREE_MAGIC)
        offset = self._offset
        self._file.write(node)
        self._offset += len(node)
        return offset, len(node), sum(n for _, n in indirect)

    def close(self) -> Version:
        """Write the b-tree and the manifest; returns the version written."""
        try:
            root = self._leaf() if self._entries else None
        finally:
            self._file.close()
        commit_time = time.time_ns()
        if root is None:
            os.remove(os.path.join(self.path, self.data_file))
            # as tensorstore writes an empty tree: file 0 of the table is ""
            table, location, stats = [""], (0, _MISSING, _MISSING), (0, 0, 0)
        else:
            table = [self.data_file]
            offset, length, indirect_bytes = root
            location = (0, offset, length)
            stats = (len(self._entries), length, indirect_bytes)
        body = (os.urandom(16) + _varint(0) + _varint(MAX_INLINE_VALUE_BYTES)
                + _varint(MAX_DECODED_NODE_BYTES)
                + bytes([VERSION_TREE_ARITY_LOG2]) + _varint(1) + struct.pack("<i", ZSTD_LEVEL)
                + _encode_data_file_table(table)
                + _varint(1) + _varint(1) + bytes([0]) + _varints(location)
                + _varints(stats) + struct.pack("<Q", commit_time)
                + _varint(0))
        manifest = encode_file(body, MANIFEST_MAGIC)
        tmp = os.path.join(self.path, MANIFEST_FILE + ".tmp")
        with open(tmp, "wb") as f:
            f.write(manifest)
        os.replace(tmp, os.path.join(self.path, MANIFEST_FILE))
        loc = None if root is None else Location(self.data_file, "", *location[1:])
        self.version = Version(1, 0, loc, stats[0], commit_time)
        return self.version

