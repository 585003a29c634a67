"""A reader for OCDBT key-value stores, the layout Orbax writes with
``use_ocdbt=True`` (tensorstore's "optionally-cooperative distributed
B+tree"), in pure Python over the port's zstd decoder.

A store is a directory:

- ``manifest.ocdbt``: the store's configuration and, in a "single"
  manifest, its list of versions, each with the location of its B-tree
  root; in a "numbered" store the versions are in the newest
  ``manifest.<16 hex digits>``;
- B-tree nodes and out-of-line values, in data files under ``d/`` (or,
  for an Orbax checkpoint, ``ocdbt.process_<i>/d/``), named by the data
  file table of the manifest or node that refers to them.

Manifests and nodes share one framing: a 4-byte big-endian magic
(``0x0cdb3a2a`` manifest, ``0x0cdb20de`` node), the file's length as a
u64 LE, a varint format version (0), a u8 compression flag (0 none, 1
zstd), the body, and a CRC-32C (u32 LE) of every byte before it. The body
is made of varints, u8s and byte strings, in columns: every field of
every entry, then the next field. Keys and data-file paths are
prefix-compressed against the previous entry; an interior node's children
store their keys without the prefix that the whole subtree shares.

``read_store`` takes the newest version and returns every key with its
value. What it does not know (another format version, value kind or
compression) raises ``OcdbtError`` naming it; it never returns part of a
tree. Values are not checksummed by the format: a value that is a zstd
frame is checked by its own decoding.
"""

from __future__ import annotations

import dataclasses
import os
import re
import struct
from typing import Dict, List, Optional, Tuple

from vqa_tpu_torch.native import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_NUMBERED = re.compile(r"^manifest\.[0-9a-f]{16}$")
_NO_LOCATION = (1 << 64) - 1  # offset and length of an empty tree's root
MANIFEST_LIMIT = 64 << 20  # decoded bytes a manifest may take


class OcdbtError(ValueError):
    """A store this reader cannot read, or one that is damaged."""


def _crc32c_table() -> List[int]:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data) -> int:
    """CRC-32C (Castagnoli), as the OCDBT framing stores it."""
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in bytes(data):
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Cursor:
    """Reads the fields of a decoded body in order."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def _need(self, n: int) -> None:
        if self.pos + n > len(self.data):
            raise OcdbtError(f"{self.what} is truncated")

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            self._need(1)
            b = self.data[self.pos]
            self.pos += 1
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise OcdbtError(f"{self.what} has a varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def u8(self) -> int:
        self._need(1)
        self.pos += 1
        return self.data[self.pos - 1]

    def raw(self, n: int) -> bytes:
        self._need(n)
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def u64s(self, n: int) -> List[int]:
        return list(struct.unpack(f"<{n}Q", self.raw(8 * n)))

    def end(self) -> None:
        if self.pos != len(self.data):
            raise OcdbtError(f"{self.what} has {len(self.data) - self.pos} bytes after its end")


def _unframe(data: bytes, magic: int, what: str, limit: int = MANIFEST_LIMIT) -> bytes:
    """The decoded body of a manifest or node file, after checking its
    magic, length, format version and CRC-32C."""
    if len(data) < 18:
        raise OcdbtError(f"{what} is too short")
    got_magic, length = struct.unpack(">I", data[:4])[0], struct.unpack("<Q", data[4:12])[0]
    if got_magic != magic:
        raise OcdbtError(f"{what} has magic {got_magic:#010x}, expected {magic:#010x}")
    if length != len(data):
        raise OcdbtError(f"{what} says it is {length} bytes long but is {len(data)}")
    want_crc = struct.unpack("<I", data[-4:])[0]
    if crc32c(data[:-4]) != want_crc:
        raise OcdbtError(f"{what} fails its CRC-32C check")
    head = _Cursor(data[12:-4], what)
    version = head.varint()
    if version != 0:
        raise OcdbtError(f"{what} has format version {version}; only 0 is known")
    compression = head.u8()
    body = data[12 + head.pos:-4]
    if compression == 0:
        return body
    if compression != 1:
        raise OcdbtError(f"{what} has compression format {compression}; only 0 and 1 (zstd) "
                         "are known")
    try:
        size = zstd.content_size(body)
        if size is None:  # a streamed frame: the store's bound on a node holds it
            return zstd.decompress_bounded(body, limit).tobytes()
        if size > limit:
            raise OcdbtError(f"{what} decodes to {size} bytes, over the bound of {limit}")
        return zstd.decompress(body, size).tobytes()
    except zstd.ZstdError as e:
        raise OcdbtError(f"{what}: {e}") from e


def _data_file_table(cur: _Cursor) -> List[str]:
    n = cur.varint()
    prefix = [0] + cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    cur.varints(n)  # the base-path length: where each path's base ends
    paths: List[bytes] = []
    for i in range(n):
        if prefix[i] > (len(paths[-1]) if paths else 0):
            raise OcdbtError(f"{cur.what}'s data file table shares more than a path has")
        paths.append((paths[-1][:prefix[i]] if i else b"") + cur.raw(suffix[i]))
    return [p.decode() for p in paths]


def _keys(cur: _Cursor, n: int, extra_column: bool) -> Tuple[List[bytes], List[int]]:
    """Prefix-compressed keys; an interior node stores, between the key
    lengths and the key bytes, each child's common prefix length."""
    prefix = [0] + cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    shared = cur.varints(n) if extra_column else []
    keys: List[bytes] = []
    for i in range(n):
        if prefix[i] > (len(keys[-1]) if keys else 0):
            raise OcdbtError(f"{cur.what}'s key shares more than the previous key has")
        keys.append((keys[-1][:prefix[i]] if i else b"") + cur.raw(suffix[i]))
    return keys, shared


@dataclasses.dataclass(frozen=True)
class Config:
    uuid: bytes
    manifest_kind: int  # 0 single, 1 numbered
    max_inline_value_bytes: int
    max_decoded_node_bytes: int
    version_tree_arity_log2: int
    compression: int  # 0 none, 1 zstd


@dataclasses.dataclass(frozen=True)
class Version:
    generation: int
    root_height: int
    root: Optional[Tuple[str, int, int]]  # data file, offset, length; None: empty
    num_keys: int


def _config(cur: _Cursor) -> Config:
    uuid = cur.raw(16)
    kind = cur.varint()
    max_inline = cur.varint()
    max_node = cur.varint()
    arity = cur.u8()
    compression = cur.varint()
    if compression == 1:
        cur.raw(4)  # the zstd level, an int32 LE: not needed to read
    elif compression != 0:
        raise OcdbtError(f"{cur.what} names compression method {compression}; only 0 and 1 "
                         "(zstd) are known")
    if kind not in (0, 1):
        raise OcdbtError(f"{cur.what} has manifest kind {kind}; only 0 and 1 are known")
    return Config(uuid, kind, max_inline, max_node, arity, compression)


def _versions(cur: _Cursor) -> List[Version]:
    """The inline version list of a manifest, then the references to its
    version-tree nodes, which hold only older versions."""
    files = _data_file_table(cur)
    n = cur.varint()
    generation = cur.varints(n)
    height = [cur.u8() for _ in range(n)]
    file_id, offset, length = cur.varints(n), cur.varints(n), cur.varints(n)
    num_keys = cur.varints(n)
    cur.varints(n)  # bytes of the tree
    cur.varints(n)  # bytes of indirect values
    cur.u64s(n)  # commit times
    versions = []
    for i in range(n):
        if offset[i] == _NO_LOCATION and length[i] == _NO_LOCATION:
            root = None
        else:
            if file_id[i] >= len(files):
                raise OcdbtError(f"{cur.what}: version {generation[i]} names data file "
                                 f"{file_id[i]} of {len(files)}")
            root = (files[file_id[i]], offset[i], length[i])
        versions.append(Version(generation[i], height[i], root, num_keys[i]))
    m = cur.varint()  # version-tree node references, in columns
    older = cur.varints(m)
    cur.varints(m), cur.varints(m), cur.varints(m)  # their data file, offset, length
    cur.varints(m)  # generations each holds
    cur.u64s(m)  # commit times
    cur.raw(m)  # heights
    cur.end()
    if not versions:
        raise OcdbtError(f"{cur.what} lists no version")
    newest = max(v.generation for v in versions)
    if any(g >= newest for g in older):
        raise OcdbtError(f"{cur.what}: a version-tree node holds a version newer than the "
                         "manifest's own")
    return versions


def _read_file(path: str) -> bytes:
    try:
        with open(path, "rb") as f:
            return f.read()
    except OSError as e:
        raise OcdbtError(f"cannot read {path}: {e}") from e


def read_manifest(directory: str) -> Tuple[Config, Version]:
    """The store's configuration and its newest version."""
    top = os.path.join(directory, "manifest.ocdbt")
    cur = _Cursor(_unframe(_read_file(top), MANIFEST_MAGIC, top), top)
    config = _config(cur)
    if config.manifest_kind == 1:  # numbered: the versions are in manifest.<n>
        cur.end()
        numbered = sorted(f for f in os.listdir(directory) if _NUMBERED.match(f))
        if not numbered:
            raise OcdbtError(f"{directory}: a numbered manifest with no manifest.<n> file")
        path = os.path.join(directory, numbered[-1])
        cur = _Cursor(_unframe(_read_file(path), MANIFEST_MAGIC, path), path)
        _config(cur)
    versions = _versions(cur)
    return config, max(versions, key=lambda v: v.generation)


@dataclasses.dataclass(frozen=True)
class IndirectValue:
    """A value stored out of line: ``length`` bytes at ``offset`` of a data
    file (relative to the store's directory)."""

    path: str
    offset: int
    length: int


class _Files:
    """Data files read whole, once each, inside the store's directory."""

    def __init__(self, directory: str):
        self.directory = os.path.realpath(directory)
        self.cache: Dict[str, bytes] = {}

    def path(self, relative: str) -> str:
        full = os.path.realpath(os.path.join(self.directory, relative))
        if os.path.commonpath([full, self.directory]) != self.directory:
            raise OcdbtError(f"data file {relative!r} lies outside {self.directory}")
        return full

    def read(self, relative: str, offset: int, length: int) -> memoryview:
        if relative not in self.cache:
            self.cache[relative] = _read_file(self.path(relative))
        data = self.cache[relative]
        if offset + length > len(data):
            raise OcdbtError(f"{relative}: {length} bytes at {offset} pass its end "
                             f"({len(data)} bytes)")
        return memoryview(data)[offset:offset + length]


def _walk(files: _Files, location: Tuple[str, int, int], height: int, prefix: bytes,
          limit: int, out: List[Tuple[bytes, object]]) -> None:
    path, offset, length = location
    what = f"B-tree node at {path}:{offset}"
    cur = _Cursor(_unframe(bytes(files.read(path, offset, length)), NODE_MAGIC, what, limit),
                  what)
    got_height = cur.u8()
    if got_height != height:
        raise OcdbtError(f"{what} has height {got_height}, expected {height}")
    table = _data_file_table(cur)
    n = cur.varint()
    keys, shared = _keys(cur, n, extra_column=height > 0)

    def file_of(i: int) -> str:
        if i >= len(table):
            raise OcdbtError(f"{what} names data file {i} of {len(table)}")
        return table[i]

    if height > 0:
        file_ids, offsets, lengths = cur.varints(n), cur.varints(n), cur.varints(n)
        cur.varints(n), cur.varints(n), cur.varints(n)  # statistics of each subtree
        cur.end()
        for i in range(n):
            if shared[i] > len(keys[i]):
                raise OcdbtError(f"{what}: a child shares more than its key holds")
            _walk(files, (file_of(file_ids[i]), offsets[i], lengths[i]), height - 1,
                  prefix + keys[i][:shared[i]], limit, out)
        return
    value_lengths = cur.varints(n)
    kinds = [cur.u8() for _ in range(n)]
    unknown = sorted({k for k in kinds if k not in (0, 1)})
    if unknown:
        raise OcdbtError(f"{what} has value kind {unknown[0]}; only 0 (inline) and 1 "
                         "(indirect) are known")
    indirect = [i for i in range(n) if kinds[i] == 1]
    file_ids, offsets = cur.varints(len(indirect)), cur.varints(len(indirect))
    where = dict(zip(indirect, zip(file_ids, offsets)))
    for i in range(n):
        if kinds[i] == 1:
            fid, off = where[i]
            value: object = IndirectValue(file_of(fid), off, value_lengths[i])
        else:
            value = cur.raw(value_lengths[i])
        out.append((prefix + keys[i], value))
    cur.end()


def read_store(directory: str) -> Dict[bytes, memoryview]:
    """Every key of the store's newest version with its value's bytes."""
    config, version = read_manifest(directory)
    entries: List[Tuple[bytes, object]] = []
    files = _Files(directory)
    if version.root is not None:
        _walk(files, version.root, version.root_height, b"", config.max_decoded_node_bytes,
              entries)
    if len(entries) != version.num_keys:
        raise OcdbtError(f"{directory}: the tree holds {len(entries)} keys, its version "
                         f"says {version.num_keys}")
    out: Dict[bytes, memoryview] = {}
    for key, value in entries:
        if isinstance(value, IndirectValue):
            out[key] = files.read(value.path, value.offset, value.length)
        else:
            out[key] = memoryview(value)
    return out
