"""Read the JAX package's orbax checkpoints without JAX, orbax, tensorstore
or a zstd package.

The JAX package saves a run as orbax directories (`yolopoint_tpu/training/
checkpoint.py`): `best/`, written by a `StandardCheckpointer`, and
`ckpts/<step>/default/`, written by its `CheckpointManager`. Each holds
`_METADATA` (the tree, as JSON) and an OCDBT key-value store (tensorstore's
"optionally-cooperative distributed B+tree") whose keys are zarr v2 arrays,
one a leaf: `params.<path>/.zarray` and its chunks `params.<path>/0.0.0.0`.
Three layers read them here:

* `OcdbtStore`: the store, read-only. `manifest.ocdbt` names the newest
  version's root B-tree node; interior and leaf nodes are walked from there
  (keys prefix-compressed, each subtree's common prefix taken off its keys;
  a value inline in its leaf or a range of a data file). Data file paths
  are relative to the store's root, so the layout where each process writes
  its own tree under `ocdbt.process_<i>/` and the root's leaves point into
  it reads as any other. Every manifest and node is checked: magic, length,
  format version, compression and CRC-32C (`utils/crc32c.py`); a mismatch
  raises naming the file. `read(key)` fetches only its value's bytes.
* `read_zarr_array`: a zarr v2 array on the store (C order, the zstd
  compressor, no filters; chunks assembled in C order, a missing chunk
  filled with `fill_value` or, where that is null, an error).
* `OrbaxCheckpoint` and `load_jax_run_variables`: the tree, and the
  counterpart of the JAX package's `load_run_variables`.

Manifests, nodes and chunks are zstd frames. `Codec` decodes them and checks
the CRCs: with the plain Python versions (`utils/zstd.py`,
`utils/crc32c.py`) for a run on the CPU, with the compiled host code
(`ops/csrc/host_zstd.cpp`) for a run on the GPU (`codec_for(device)`), with
no fallback from one to the other.
"""

from __future__ import annotations

import bisect
import ctypes
import hashlib
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from yolopoint_tpu_torch.utils import crc32c as crc_mod
from yolopoint_tpu_torch.utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
FORMAT_VERSION = 0
# the dtypes of the JAX package's checkpoints: f32 arrays, the int64 step
ZARR_DTYPES = ("<f4", "<i8")
ARRAY_VALUE_TYPES = ("np.ndarray", "jax.Array", "scalar")


class OcdbtError(ValueError):
    """An OCDBT store, zarr array or orbax tree that cannot be read."""


class Codec:
    """How frames are decompressed and checksums computed: the plain Python
    versions, or (`compiled`) the host code of `lib`, by default the kernel
    library. Counts the bytes it decoded (`bytes_in`, `bytes_out`)."""

    def __init__(self, compiled: bool, lib: Optional[ctypes.CDLL] = None):
        self.compiled = compiled
        self.lib = lib
        self.bytes_in = 0
        self.bytes_out = 0

    def zstd(self, data: bytes, what: str) -> bytes:
        """The content of the frames in `data`; each decoder holds a frame
        to the content size its header states."""
        if self.compiled:
            out = zstd.decompress_compiled(data, what, self.lib)
        else:
            out = zstd.decompress(data, what)
        self.bytes_in += len(data)
        self.bytes_out += len(out)
        return out

    def crc32c(self, data: bytes) -> int:
        return crc_mod.crc32c_compiled(data, self.lib) if self.compiled else crc_mod.crc32c(data)


def codec_for(device: str | torch.device) -> Codec:
    """The codec of a run on `device`: Python for the CPU, compiled host code
    otherwise."""
    return Codec(compiled=torch.device(device).type != "cpu")


# ---------------------------------------------------------------- the store

class _Cursor:
    """A position in an encoded manifest or node body; reads past its end
    raise naming `what`."""

    __slots__ = ("data", "pos", "what")

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise OcdbtError(f"{self.what}: truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        value = shift = 0
        for _ in range(10):
            b = self.byte()
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                return value
            shift += 7
        raise OcdbtError(f"{self.what}: varint longer than 10 bytes")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def strings(self, prefix: list[int], suffix: list[int]) -> list[bytes]:
        """Prefix-compressed strings: each after the first keeps `prefix[i-1]`
        bytes of the one before it and adds its next `suffix[i]` bytes."""
        out, prev = [], b""
        for i, n in enumerate(suffix):
            head = prefix[i - 1] if i else 0
            if head > len(prev):
                raise OcdbtError(f"{self.what}: shared prefix longer than the string before")
            prev = prev[:head] + self.take(n)
            out.append(prev)
        return out

    def end(self) -> None:
        if self.pos != len(self.data):
            raise OcdbtError(f"{self.what}: {len(self.data) - self.pos} bytes left over")


def _data_file_table(cur: _Cursor) -> list[str]:
    """The data files a manifest or node refers to, as paths relative to
    the store's root (base path and relative path joined)."""
    n = cur.varint()
    prefix = cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    base = cur.varints(n)
    paths = cur.strings(prefix, suffix)
    out = []
    for path, b in zip(paths, base):
        text = path.decode("utf-8", "strict")
        parts = text.split("/")  # "" is the file of no node: an empty tree's
        if b > len(path) or (text and (text.startswith("/") or ".." in parts or "" in parts)):
            raise OcdbtError(f"{cur.what}: bad data file path {text!r}")
        out.append(text)
    return out


@dataclass(frozen=True)
class NodeRef:
    """Where a B-tree node lies: a data file, an offset and a length."""
    path: str
    offset: int
    length: int


@dataclass
class _Node:
    height: int
    keys: list[bytes]  # full keys (the node's prefix included)
    children: list  # interior: (NodeRef, prefix of the child); leaf: bytes or NodeRef


class OcdbtStore:
    """A read-only OCDBT key-value store at `root` (a directory holding
    `manifest.ocdbt`)."""

    def __init__(self, root: str | Path, codec: Codec):
        self.root = Path(root)
        self.codec = codec
        self._nodes: dict[NodeRef, _Node] = {}
        path = self.root / "manifest.ocdbt"
        if not path.is_file():
            raise FileNotFoundError(f"{path}: no OCDBT manifest")
        raw = self._read(path.name, 0, None)
        body = self._checked(raw, MANIFEST_MAGIC, str(path))
        self.root_ref, self.root_height, self.num_keys = self._manifest(body, str(path))

    # -- files and framing

    def _read(self, rel: str, offset: int, length: Optional[int]) -> bytes:
        path = self.root / rel
        try:
            with open(path, "rb") as f:
                f.seek(offset)
                data = f.read() if length is None else f.read(length)
        except FileNotFoundError:
            raise FileNotFoundError(f"{path}: data file of {self.root} missing") from None
        if length is not None and len(data) != length:
            raise OcdbtError(f"{path}: {length} bytes at {offset} asked for, "
                             f"{len(data)} there")
        return data

    def _checked(self, raw: bytes, magic: int, what: str) -> bytes:
        """The body of a manifest or node: magic, length, version,
        compression and CRC-32C checked, decompressed."""
        if len(raw) < 18:
            raise OcdbtError(f"{what}: {len(raw)} bytes is too short")
        if int.from_bytes(raw[:4], "big") != magic:
            raise OcdbtError(f"{what}: magic {raw[:4].hex()} is not {magic:08x}")
        if int.from_bytes(raw[4:12], "little") != len(raw):
            raise OcdbtError(f"{what}: length field {int.from_bytes(raw[4:12], 'little')} "
                             f"!= {len(raw)} bytes")
        want = int.from_bytes(raw[-4:], "little")
        got = self.codec.crc32c(raw[:-4])
        if got != want:
            raise OcdbtError(f"{what}: CRC-32C {got:08x} does not match {want:08x}")
        cur = _Cursor(raw[12:-4], what)
        version, compression = cur.varint(), cur.varint()
        if version != FORMAT_VERSION:
            raise OcdbtError(f"{what}: format version {version}")
        body = cur.data[cur.pos:]
        if compression == 0:
            return body
        if compression != 1:
            raise OcdbtError(f"{what}: compression {compression} (0 none and 1 zstd are read)")
        return self.codec.zstd(body, what)

    # -- manifest

    def _manifest(self, body: bytes, what: str) -> tuple[Optional[NodeRef], int, int]:
        cur = _Cursor(body, what)
        cur.take(16)  # uuid
        kind = cur.varint()
        if kind != 0:
            raise OcdbtError(f"{what}: manifest kind {kind} (only the single-file kind 0 is "
                             "read)")
        cur.varint()  # largest inline value
        cur.varint()  # largest decoded node
        cur.byte()  # version tree arity (log2)
        compression = cur.varint()
        if compression == 1:
            cur.take(4)  # zstd level
        elif compression != 0:
            raise OcdbtError(f"{what}: compression {compression} in the config")
        files = _data_file_table(cur)
        n = cur.varint()
        if n == 0:
            raise OcdbtError(f"{what}: no version")
        gens = cur.varints(n)
        heights = [cur.byte() for _ in range(n)]
        fids, offsets, lengths = cur.varints(n), cur.varints(n), cur.varints(n)
        num_keys = cur.varints(n)
        cur.varints(n)  # tree bytes
        cur.varints(n)  # indirect value bytes
        cur.take(8 * n)  # commit times
        # the references to version tree nodes that follow hold older versions
        # only: the newest is always inline
        if any(b <= a for a, b in zip(gens, gens[1:])):
            raise OcdbtError(f"{what}: generations out of order")
        if num_keys[-1] == 0:
            return None, 0, 0
        if fids[-1] >= len(files) or not files[fids[-1]]:
            raise OcdbtError(f"{what}: root node in data file {fids[-1]} of {len(files)}")
        return NodeRef(files[fids[-1]], offsets[-1], lengths[-1]), heights[-1], num_keys[-1]

    # -- nodes

    def _node(self, ref: NodeRef, height: int, prefix: bytes) -> _Node:
        node = self._nodes.get(ref)
        if node is not None:
            return node
        what = f"{self.root / ref.path} [{ref.offset}:+{ref.length}]"
        cur = _Cursor(self._checked(self._read(ref.path, ref.offset, ref.length),
                                    NODE_MAGIC, what), what)
        if cur.byte() != height:
            raise OcdbtError(f"{what}: node height is not {height}")
        files = _data_file_table(cur)
        n = cur.varint()
        if n == 0:
            raise OcdbtError(f"{what}: empty node")
        key_prefix = cur.varints(n - 1)
        key_suffix = cur.varints(n)
        common = cur.varints(n) if height else None
        keys = [prefix + k for k in cur.strings(key_prefix, key_suffix)]
        if any(b <= a for a, b in zip(keys, keys[1:])):
            raise OcdbtError(f"{what}: keys out of order")
        children: list = []
        if height:
            fids, offsets, lengths = cur.varints(n), cur.varints(n), cur.varints(n)
            cur.varints(3 * n)  # keys, tree bytes, indirect value bytes of each subtree
            for i in range(n):
                if (fids[i] >= len(files) or not files[fids[i]]
                        or common[i] > len(keys[i]) - len(prefix)):
                    raise OcdbtError(f"{what}: bad child reference {i}")
                children.append((NodeRef(files[fids[i]], offsets[i], lengths[i]),
                                 keys[i][:len(prefix) + common[i]]))
        else:
            lengths = cur.varints(n)
            kinds = cur.varints(n)
            if any(k not in (0, 1) for k in kinds):
                raise OcdbtError(f"{what}: value kind not inline (0) or indirect (1)")
            indirect = [i for i in range(n) if kinds[i]]
            fids = cur.varints(len(indirect))
            offsets = dict(zip(indirect, cur.varints(len(indirect))))
            fid_of = dict(zip(indirect, fids))
            for i in range(n):
                if kinds[i]:
                    if fid_of[i] >= len(files) or not files[fid_of[i]]:
                        raise OcdbtError(f"{what}: value in data file {fid_of[i]} of "
                                         f"{len(files)}")
                    children.append(NodeRef(files[fid_of[i]], offsets[i], lengths[i]))
                else:
                    children.append(cur.take(lengths[i]))
        cur.end()
        node = _Node(height, keys, children)
        self._nodes[ref] = node
        return node

    def _leaves(self, ref: NodeRef, height: int, prefix: bytes):
        node = self._node(ref, height, prefix)
        if not height:
            yield node
            return
        for child, child_prefix in node.children:
            yield from self._leaves(child, height - 1, child_prefix)

    def list(self) -> list[bytes]:
        """Every key, in order."""
        if self.root_ref is None:
            return []
        keys = [k for leaf in self._leaves(self.root_ref, self.root_height, b"")
                for k in leaf.keys]
        if len(keys) != self.num_keys:
            raise OcdbtError(f"{self.root}: {len(keys)} keys, the manifest says "
                             f"{self.num_keys}")
        return keys

    def read(self, key: str | bytes) -> bytes:
        """The value of `key` (only its bytes are read); KeyError if absent."""
        k = key.encode() if isinstance(key, str) else key
        if self.root_ref is None:
            raise KeyError(key)
        ref, height, prefix = self.root_ref, self.root_height, b""
        while True:
            node = self._node(ref, height, prefix)
            i = bisect.bisect_right(node.keys, k) - 1
            if not height:
                if i < 0 or node.keys[i] != k:
                    raise KeyError(key)
                value = node.children[i]
                return value if isinstance(value, bytes) else self._read(
                    value.path, value.offset, value.length)
            if i < 0:
                raise KeyError(key)
            (ref, prefix), height = node.children[i], height - 1


# -------------------------------------------------------------------- zarr v2

def read_zarr_array(store: OcdbtStore, name: str) -> np.ndarray:
    """The zarr v2 array `name` of `store`, as a numpy array."""
    what = f"{store.root}: {name}"
    try:
        meta = json.loads(store.read(f"{name}/.zarray"))
    except KeyError:
        raise OcdbtError(f"{what}: no {name}/.zarray") from None
    if meta.get("zarr_format") != 2:
        raise OcdbtError(f"{what}: zarr_format {meta.get('zarr_format')} (2 is read)")
    if meta.get("order", "C") != "C":
        raise OcdbtError(f"{what}: order {meta.get('order')} (C is read)")
    if meta.get("filters"):
        raise OcdbtError(f"{what}: filters {meta['filters']} (none are read)")
    compressor = meta.get("compressor") or {}
    if compressor.get("id") != "zstd":
        raise OcdbtError(f"{what}: compressor {compressor.get('id')} (zstd is read)")
    if meta.get("dtype") not in ZARR_DTYPES:
        raise OcdbtError(f"{what}: dtype {meta.get('dtype')!r} (read: {ZARR_DTYPES})")
    dtype = np.dtype(meta["dtype"])
    sep = meta.get("dimension_separator", ".")
    if sep not in (".", "/"):
        raise OcdbtError(f"{what}: dimension_separator {sep!r}")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks) or any(c < 1 for c in chunks):
        raise OcdbtError(f"{what}: chunks {chunks} do not fit shape {shape}")
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    out = np.empty(shape, dtype)
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    for index in np.ndindex(*grid):
        key = f"{name}/" + (sep.join(map(str, index)) if index else "0")
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(index, chunks, shape))
        try:
            raw = store.read(key)
        except KeyError:
            if meta.get("fill_value") is None:
                raise OcdbtError(f"{what}: chunk {key} missing and no fill_value") from None
            # zarr v2 writes NaN and the infinities as strings, which numpy reads
            out[region] = np.asarray(meta["fill_value"]).astype(dtype)
            continue
        data = store.codec.zstd(raw, f"{store.root}: {key}")
        if len(data) != chunk_bytes:
            raise OcdbtError(f"{what}: chunk {key} holds {len(data)} bytes, not {chunk_bytes}")
        chunk = np.frombuffer(data, dtype).reshape(chunks)
        out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    return out


# ----------------------------------------------------------------- the tree

class OrbaxCheckpoint:
    """An orbax checkpoint directory of the JAX package (`_METADATA` beside
    an OCDBT store): its tree of arrays, read on demand."""

    def __init__(self, directory: str | Path, codec: Codec):
        self.directory = Path(directory)
        meta_path = self.directory / "_METADATA"
        if not meta_path.is_file():
            raise FileNotFoundError(f"{meta_path}: not an orbax checkpoint")
        meta = json.loads(meta_path.read_text())
        if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
            raise OcdbtError(f"{meta_path}: use_ocdbt {meta.get('use_ocdbt')}, use_zarr3 "
                             f"{meta.get('use_zarr3')} (OCDBT with zarr v2 is read)")
        self.leaves: dict[tuple[str, ...], str] = {}
        for entry in meta["tree_metadata"].values():
            keys = tuple(str(k["key"]) for k in entry["key_metadata"])
            self.leaves[keys] = entry["value_metadata"]["value_type"]
        self.store = OcdbtStore(self.directory, codec)

    def has(self, top: str) -> bool:
        """True where the tree has a subtree (or leaf) `top` holding arrays."""
        return any(k[0] == top and t in ARRAY_VALUE_TYPES for k, t in self.leaves.items())

    def array(self, keys: tuple[str, ...]) -> np.ndarray:
        kind = self.leaves.get(keys)
        if kind not in ARRAY_VALUE_TYPES:
            raise OcdbtError(f"{self.directory}: {'.'.join(keys)} is {kind}, not an array")
        return read_zarr_array(self.store, ".".join(keys))

    def subtree(self, top: str) -> dict:
        """The nested dict of the arrays under `top`, read from the store."""
        tree: dict = {}
        for keys, kind in self.leaves.items():
            if keys[0] != top or len(keys) < 2:
                continue
            if kind not in ARRAY_VALUE_TYPES:
                raise OcdbtError(f"{self.directory}: {'.'.join(keys)} is {kind}")
            node = tree
            for k in keys[1:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = self.array(keys)
        return tree


def resolve_checkpoint(path: str | Path) -> Path:
    """The checkpoint directory the JAX package's `load_run_variables` reads
    for `path`: a run directory's `best/`, else its numerically newest
    `ckpts/<step>`; else `path` itself (`best/` or a step directory). A step
    directory of the JAX package's `CheckpointManager` keeps its tree in
    `default/`, which is taken. Raises FileNotFoundError where the result
    holds no `_METADATA`."""
    p = Path(path).resolve()
    if (p / "best").exists():
        p = p / "best"
    elif (p / "ckpts").exists():
        steps = sorted(int(d.name) for d in (p / "ckpts").iterdir() if d.name.isdigit())
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {p / 'ckpts'}")
        p = p / "ckpts" / str(steps[-1])
    if not (p / "_METADATA").is_file() and (p / "default" / "_METADATA").is_file():
        p = p / "default"
    if not (p / "_METADATA").is_file():
        raise FileNotFoundError(
            f"{path}: no orbax checkpoint (looked for _METADATA in {p}, after best/ and "
            "the newest ckpts/<step>)")
    return p


def load_jax_run_variables(path: str | Path, prefer_ema: bool = True,
                           device: str | torch.device = "cpu") -> dict:
    """What the JAX package's `load_run_variables(path, prefer_ema)` returns,
    as nested dicts of numpy arrays: `{"params", "batch_stats"}`, the EMA
    shadow in place of the parameters where the checkpoint has one. Reads
    only those arrays, decoded as a run on `device` decodes them
    (`codec_for`)."""
    ckpt = OrbaxCheckpoint(resolve_checkpoint(path), codec_for(device))
    top = "ema_params" if prefer_ema and ckpt.has("ema_params") else "params"
    if not ckpt.has(top):
        raise OcdbtError(f"{ckpt.directory}: no params in the checkpoint")
    return {"params": ckpt.subtree(top), "batch_stats": ckpt.subtree("batch_stats")}


def array_digests(path: str | Path, codec: Codec) -> dict[str, dict]:
    """`{key: {"shape", "dtype", "sha256"}}` of every array of the checkpoint
    at `path` (`resolve_checkpoint`), the key its path joined by dots and
    the digest that of its bytes in C order."""
    ckpt = OrbaxCheckpoint(resolve_checkpoint(path), codec)
    out = {}
    for keys, kind in sorted(ckpt.leaves.items()):
        if kind in ARRAY_VALUE_TYPES:
            a = ckpt.array(keys)
            out[".".join(keys)] = {"shape": list(a.shape), "dtype": a.dtype.str,
                                   "sha256": hashlib.sha256(a.tobytes()).hexdigest()}
    return out
