"""Read an Orbax ``StandardCheckpointer`` directory without orbax,
tensorstore or a zstd library: the tree the JAX trainer saves
(``vqa_tpu/training/checkpoint.py:save_checkpoint``) as numpy arrays.

A checkpoint directory holds:

- ``_METADATA`` (JSON): the tree. Each leaf has its key path, each key
  with its ``key_type`` (1: a sequence index, 2: a dict key), and its
  ``value_metadata`` (``value_type`` ``jax.Array``/``np.ndarray``, a
  ``scalar``, or ``None``); and the layout flags ``use_ocdbt`` and
  ``use_zarr3``;
- one zarr v2 array per array leaf, named by the leaf's key path joined
  with dots: ``<name>/.zarray`` (JSON: shape, chunks, dtype, compressor,
  fill value, order) and one value per chunk, ``<name>/0.0`` (the chunk's
  grid indices joined with the dimension separator; ``0`` for a 0-d
  array). With ``use_ocdbt`` they are keys of the OCDBT store in the
  directory (``compat/ocdbt.py``), else files under it.

A chunk is zstd-compressed or raw, C order, full chunk shape even at an
array's edge (cut to the array there); a chunk that is missing holds the
fill value. Every chunk of the tree decodes in one call to the native
decoder's thread pool. ``bfloat16`` arrays come back as their exact bits,
in a uint16 array whose dtype carries ``metadata={"dtype": "bfloat16"}``
(``is_bfloat16``); a scalar leaf comes back as a Python number, as the
JAX restore gives it. What this reader does not handle (zarr3, another
compressor, filters, Fortran order, another value type) raises
``OrbaxError`` naming it.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import struct
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np

from vqa_tpu_torch.compat import ocdbt
from vqa_tpu_torch.native import zstd

BFLOAT16 = np.dtype(np.uint16, metadata={"dtype": "bfloat16"})
_SEQUENCE, _DICT = 1, 2
_ARRAY_TYPES = ("jax.Array", "np.ndarray")


class OrbaxError(ValueError):
    """A checkpoint this reader cannot read, or one that is damaged."""


def is_bfloat16(arr: np.ndarray) -> bool:
    """Whether ``arr`` holds bfloat16 bits (as this module returns them)."""
    return (arr.dtype.metadata or {}).get("dtype") == "bfloat16"


def to_float32(arr: np.ndarray) -> np.ndarray:
    """bfloat16 bits (``is_bfloat16``) as the float32 values they hold."""
    return (arr.astype(np.uint32) << 16).view(np.float32)


def _dtype(name: str) -> np.dtype:
    if name == "bfloat16":
        return BFLOAT16
    try:
        dt = np.dtype(name)
    except TypeError as e:
        raise OrbaxError(f"zarr dtype {name!r} is not supported") from e
    if dt.kind not in "biuf" or dt.fields is not None:
        raise OrbaxError(f"zarr dtype {name!r} is not supported")
    return dt


def _fill(value, dtype: np.dtype) -> np.ndarray:
    """A zarr ``fill_value`` as one element of ``dtype`` (null: zero)."""
    if value is None:
        return np.zeros((), dtype)
    if isinstance(value, str):  # JSON spells the special floats out
        value = {"NaN": math.nan, "Infinity": math.inf, "-Infinity": -math.inf}[value]
    if dtype is BFLOAT16:
        bits = struct.unpack("<I", struct.pack("<f", float(value)))[0]
        if math.isnan(value):
            return np.asarray(0x7FC0, BFLOAT16)
        # round to nearest even, as a float32 → bfloat16 cast does
        return np.asarray((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16, BFLOAT16)
    return np.asarray(value, dtype)


class _ArraySpec:
    """One zarr v2 array: its ``.zarray`` read and checked."""

    def __init__(self, name: str, meta: Mapping[str, Any]):
        self.name = name
        if meta.get("zarr_format") != 2:
            raise OrbaxError(f"{name}: zarr_format {meta.get('zarr_format')}, only 2 is read")
        if meta.get("order", "C") != "C":
            raise OrbaxError(f"{name}: order {meta['order']!r}, only 'C' is read")
        if meta.get("filters"):
            raise OrbaxError(f"{name}: zarr filters {meta['filters']} are not supported")
        compressor = meta.get("compressor")
        if compressor is not None and compressor.get("id") != "zstd":
            raise OrbaxError(f"{name}: compressor {compressor.get('id')!r} is not supported; "
                             "only zstd or none")
        self.compressed = compressor is not None
        self.shape = tuple(int(s) for s in meta["shape"])
        self.chunks = tuple(int(c) for c in meta["chunks"])
        if len(self.chunks) != len(self.shape) or any(c <= 0 for c in self.chunks):
            raise OrbaxError(f"{name}: chunks {self.chunks} do not fit shape {self.shape}")
        self.dtype = _dtype(meta["dtype"])
        self.byteswap = self.dtype.byteorder == ">"
        self.fill = _fill(meta.get("fill_value"), self.dtype)
        self.separator = meta.get("dimension_separator", ".")
        self.grid = tuple(-(-s // c) for s, c in zip(self.shape, self.chunks))
        self.chunk_bytes = int(np.prod(self.chunks, dtype=np.int64)) * self.dtype.itemsize

    def chunk_keys(self) -> List[Tuple[Tuple[int, ...], str]]:
        if not self.shape:
            return [((), "0")]
        return [(idx, self.separator.join(map(str, idx)))
                for idx in itertools.product(*map(range, self.grid))]


class _Chunks:
    """The values of a checkpoint's keys: an OCDBT store or plain files."""

    def __init__(self, path: str, use_ocdbt: bool):
        self.path = path
        self.store: Optional[Dict[bytes, memoryview]] = None
        if use_ocdbt:
            try:
                self.store = ocdbt.read_store(path)
            except ocdbt.OcdbtError as e:
                raise OrbaxError(f"{path}: {e}") from e

    def get(self, key: str) -> Optional[memoryview]:
        if self.store is not None:
            return self.store.get(key.encode())
        file = os.path.join(self.path, *key.split("/"))
        if not os.path.isfile(file):
            return None
        with open(file, "rb") as f:
            return memoryview(f.read())


def _gather(chunks: _Chunks, names: List[str]):
    """Every named array's spec and chunk values: ``(specs, pieces,
    frames, sizes, decoded_at)``, where ``pieces`` holds (array, chunk
    index, bytes) and the compressed ones are also listed as ``frames``
    of ``sizes`` decoded bytes, for the decoder's one call, to go back
    into ``pieces`` at ``decoded_at``."""
    specs: Dict[str, _ArraySpec] = {}
    pieces: List[Tuple[str, Tuple[int, ...], Any]] = []
    frames, sizes, decoded_at = [], [], []
    for name in names:
        raw = chunks.get(f"{name}/.zarray")
        if raw is None:
            raise OrbaxError(f"{name}: no .zarray in the checkpoint")
        spec = specs[name] = _ArraySpec(name, json.loads(bytes(raw)))
        for idx, key in spec.chunk_keys():
            value = chunks.get(f"{name}/{key}")
            if value is None:
                continue  # a chunk never written holds the fill value
            if spec.compressed:
                decoded_at.append(len(pieces))
                frames.append(value)
                sizes.append(spec.chunk_bytes)
            elif len(value) != spec.chunk_bytes:
                raise OrbaxError(f"{name}/{key}: {len(value)} bytes, a chunk is "
                                 f"{spec.chunk_bytes}")
            pieces.append((name, idx, value))
    return specs, pieces, frames, sizes, decoded_at


def _read_arrays(chunks: _Chunks, names: List[str]) -> Dict[str, np.ndarray]:
    """Every named array, its compressed chunks decoded in one native call.
    An array of one full chunk is a view of the decoded bytes; the others
    are assembled from their chunks over the fill value."""
    specs, pieces, frames, sizes, decoded_at = _gather(chunks, names)
    try:
        decoded = zstd.decompress_many(frames, sizes)
    except zstd.ZstdError as e:
        raise OrbaxError(f"a chunk of the checkpoint does not decode: {e}") from e
    for at, out in zip(decoded_at, decoded):
        pieces[at] = pieces[at][:2] + (out,)
    by_array: Dict[str, List[Tuple[Tuple[int, ...], Any]]] = {name: [] for name in names}
    for name, idx, data in pieces:
        by_array[name].append((idx, data))
    arrays = {}
    for name, spec in specs.items():
        parts = [(idx, np.frombuffer(data, np.uint8).view(spec.dtype).reshape(spec.chunks))
                 for idx, data in by_array[name]]
        if spec.byteswap:
            parts = [(idx, chunk.byteswap().view(chunk.dtype.newbyteorder("=")))
                     for idx, chunk in parts]
        if spec.chunks == spec.shape and len(parts) == 1:
            chunk = parts[0][1]  # a raw chunk is still a view of the file's bytes
            arrays[name] = chunk if chunk.flags.writeable else chunk.copy()
            continue
        arr = arrays[name] = np.empty(spec.shape, parts[0][1].dtype if parts else spec.dtype)
        arr.fill(spec.fill)
        for idx, chunk in parts:
            region = tuple(slice(i * c, min((i + 1) * c, n))
                           for i, c, n in zip(idx, spec.chunks, spec.shape))
            arr[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    return arrays


def _nest(leaves: List[Tuple[List[Tuple[str, int]], Any]]) -> Any:
    """Rebuild the nested tree: dict keys as dicts, sequence indices as
    lists."""
    root: Dict[Any, Any] = {}
    kinds: Dict[int, int] = {}

    def put(node: Dict, path: List[Tuple[str, int]], value: Any) -> None:
        key, kind = path[0]
        if kinds.setdefault(id(node), kind) != kind:
            raise OrbaxError(f"key {key!r} mixes sequence and dict entries")
        if len(path) == 1:
            node[key] = value
        else:
            put(node.setdefault(key, {}), path[1:], value)

    for path, value in leaves:
        put(root, path, value)

    def build(node: Any) -> Any:
        if not isinstance(node, dict):
            return node
        if kinds.get(id(node)) == _SEQUENCE:
            items = sorted(node.items(), key=lambda kv: int(kv[0]))
            if [int(k) for k, _ in items] != list(range(len(items))):
                raise OrbaxError(f"sequence indices {[k for k, _ in items]} are not 0..n-1")
            return [build(v) for _, v in items]
        return {k: build(v) for k, v in node.items()}

    return build(root)


def _metadata(path: str) -> Dict[str, Any]:
    meta_path = os.path.join(path, "_METADATA")
    try:
        with open(meta_path, "r", encoding="utf-8") as f:
            meta = json.load(f)
    except OSError as e:
        raise OrbaxError(f"{path} is not an Orbax checkpoint: {e}") from e
    if meta.get("use_zarr3"):
        raise OrbaxError(f"{path} is written with zarr3, which this reader does not read")
    return meta


def _tree(path: str):
    """The checkpoint's leaves as (key path, (value type, array name)),
    the names of the arrays among them, and its keys' values."""
    meta = _metadata(path)
    leaves, names = [], []
    for entry in meta["tree_metadata"].values():
        keys = [(k["key"], int(k["key_type"])) for k in entry["key_metadata"]]
        unknown = {t for _, t in keys} - {_SEQUENCE, _DICT}
        if unknown:
            raise OrbaxError(f"{entry['key_metadata']}: key type {sorted(unknown)[0]} is not "
                             "known")
        value_type = entry["value_metadata"]["value_type"]
        name = ".".join(k for k, _ in keys)
        if value_type in _ARRAY_TYPES or value_type == "scalar":
            names.append(name)
        elif value_type != "None":
            raise OrbaxError(f"{name}: value type {value_type!r} is not supported")
        leaves.append((keys, (value_type, name)))
    return leaves, names, _Chunks(path, bool(meta.get("use_ocdbt", True)))


def zstd_frames(path: str) -> Tuple[List[Any], List[int]]:
    """The zstd frames of the checkpoint's chunks and the bytes each
    decodes to, as ``read_checkpoint`` hands them to the decoder."""
    _, names, chunks = _tree(path)
    _, _, frames, sizes, _ = _gather(chunks, names)
    return frames, sizes


def read_checkpoint(path: str) -> Dict[str, Any]:
    """The tree of the Orbax checkpoint directory ``path``, as the JAX
    package's ``load_checkpoint`` restores it without a target: nested
    dicts and lists of numpy arrays, Python scalars and Nones."""
    leaves, names, chunks = _tree(path)
    arrays = _read_arrays(chunks, names)

    def value(kind_and_name):
        value_type, name = kind_and_name
        if value_type == "None":
            return None
        if value_type == "scalar":
            return arrays[name].item()
        return arrays[name]

    return _nest([(keys, value(v)) for keys, v in leaves])


def _widen(node):
    """A tree with its bfloat16 leaves widened to float32."""
    if isinstance(node, dict):
        return {k: _widen(v) for k, v in node.items()}
    return to_float32(node) if is_bfloat16(node) else node


def inference_variables(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """The flax ``{'params', 'batch_stats'}`` of a restored trainer tree,
    bfloat16 leaves widened to float32."""
    return {"params": _widen(tree["params"]), "batch_stats": _widen(tree.get("batch_stats", {}))}


# optax.chain(clip_by_global_norm, adamw(schedule)) as the JAX trainer
# builds it (vqa_tpu/training/train.py:make_optimizer) saves its state as
# clip's empty state, then adamw's chain: scale_by_adam, the empty state of
# add_decayed_weights, scale_by_schedule
TRAINER_CHAIN = "[None, [{count, mu, nu}, None, {count}]]"


def layout(node: Any) -> str:
    """A tree's outline as ``TRAINER_CHAIN`` writes it: lists in brackets,
    dicts as their sorted keys, ``None``, anything else ``array``."""
    if isinstance(node, list):
        return "[" + ", ".join(layout(v) for v in node) + "]"
    if isinstance(node, dict):
        return "{" + ", ".join(sorted(map(str, node))) + "}"
    return "None" if node is None else "array"


def _shapes(tree: Any, path: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Tuple[int, ...]]:
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _shapes(sub, path + (key,)).items()}
    return {path: tuple(np.shape(tree))}


def _count(value: Any, what: str) -> int:
    if np.ndim(value) or not np.issubdtype(np.asarray(value).dtype, np.integer):
        raise OrbaxError(f"{what} is {value!r}, not an integer count")
    return int(value)


def training_state(tree: Mapping[str, Any], model_only: bool = False) -> Dict[str, Any]:
    """The JAX trainer's tree (``vqa_tpu/training/train.py:_state_tree``:
    ``params``, ``batch_stats``, ``opt_state``, ``step``) taken apart for a
    resume: ``params`` and ``batch_stats`` (bfloat16 widened), AdamW's
    ``mu`` and ``nu`` (trees of the params' paths and shapes), and the
    three counts ``adam_count`` (``scale_by_adam``'s), ``schedule_count``
    (``scale_by_schedule``'s) and ``step``. With ``model_only`` (a sidecar
    flagged so) the optimizer is not read, and the last five are None.

    ``opt_state`` must be ``TRAINER_CHAIN``'s layout; another one, or a
    tree without ``opt_state`` that is not ``model_only``, raises
    ``OrbaxError`` naming what it found."""
    out = dict(inference_variables(tree), mu=None, nu=None, adam_count=None,
               schedule_count=None, step=None)
    if model_only:
        return out
    if "opt_state" not in tree:
        raise OrbaxError(f"the tree holds {layout(dict(tree))} with no opt_state, and its "
                         "sidecar is not flagged model_only: there is no optimizer to resume")
    opt = tree["opt_state"]
    found = layout(opt)
    if found != TRAINER_CHAIN:
        raise OrbaxError(f"opt_state is {found}, not the JAX trainer's clip_by_global_norm → "
                         f"adamw chain {TRAINER_CHAIN}")
    adam, schedule = opt[1][0], opt[1][2]
    mu, nu = _widen(adam["mu"]), _widen(adam["nu"])
    params = _shapes(out["params"])
    for name, moment in (("mu", mu), ("nu", nu)):
        shapes = _shapes(moment)
        if shapes != params:
            diff = sorted(set(shapes.items()) ^ set(params.items()))[:4]
            raise OrbaxError(f"AdamW's {name} does not have the params' paths and shapes: "
                             + ", ".join(f"{'/'.join(p)} {s}" for p, s in diff))
    if "step" not in tree:
        raise OrbaxError("the tree holds opt_state but no step")
    out.update(mu=mu, nu=nu, adam_count=_count(adam["count"], "scale_by_adam's count"),
               schedule_count=_count(schedule["count"], "scale_by_schedule's count"),
               step=_count(tree["step"], "step"))
    return out
