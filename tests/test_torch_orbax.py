"""The port's reader of the JAX package's orbax checkpoints, on the CPU.

* zstd (`utils/zstd.py`): the Python decoder against `zstandard` on frames
  `zstandard` writes (levels 1, 3 and 19; with and without the checksum and
  the content size; a frame over 128 KB; raw, RLE and all-zero data; two
  frames end to end; a skippable frame): byte for byte. Truncated,
  bit-flipped and bad-checksum frames, and a frame that needs a dictionary,
  raise.
* The compiled twins (`ops/csrc/host_zstd.cpp`, built here with g++): the
  same outputs and the same refusals, and the same CRC-32C.
* CRC-32C: RFC 3720's vectors, and every committed manifest's and B-tree
  node's own checksum.
* OCDBT (`training/orbax_read.py`): `list()` equals tensorstore's listing on
  two committed `best/` directories (YOLOPoint-n and -s) and on a store
  tensorstore writes with interior nodes, inline values and version tree
  nodes, where every value also equals tensorstore's read.
* zarr v2: a multi-chunk array with edge chunks and a missing chunk filled
  with `fill_value`, written by tensorstore's zarr driver, equals
  tensorstore's read; filters, another compressor, order F and a missing
  chunk without a fill value raise naming the array.
* The committed checkpoints' BN statistics and `step`: equal to orbax's
  restore of them and to `tests/torch_orbax_digests.json`.
* A fresh checkpoint, end to end: the JAX package's `CheckpointManager`
  writes a YOLOPoint-n run (`best/`, `ckpts/<step>/`, the optimizer's
  moments too) in `tmp_path`; the port's `load_weights` reads the run and
  the port's forward equals the JAX forward of the EMA weights on a seeded
  64x64 input within 1e-4 (f32).
* The directory rules (`best/`, the newest step, EMA preferred or not, a
  checkpoint without EMA): the arrays orbax restores from the directory the
  JAX package's rule picks. The detection CLI's loader and the trainer's
  warm start read such a run.
"""

import ctypes
import hashlib
import json
import shutil
import subprocess
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch
import zstandard

from tests.test_torch_model import randomize_bn
from yolopoint_tpu.models import build_model as jax_build_model
from yolopoint_tpu.training.checkpoint import CheckpointManager, load_run_variables
from yolopoint_tpu.training.state import create_train_state, make_optimizer
from yolopoint_tpu_torch.models import build_model, load_weights
from yolopoint_tpu_torch.ops import _build
from yolopoint_tpu_torch.training import orbax_read
from yolopoint_tpu_torch.utils import crc32c, zstd

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
RUNS = {"n": REPO / "artifacts" / "synth_r5_pseudo_ext" / "best",
        "s": REPO / "artifacts" / "synth_s640_pseudo2" / "best"}
DIGESTS = json.loads((REPO / "tests" / "torch_orbax_digests.json").read_text())
TOL = 1e-4

_RNG = np.random.default_rng(3)
_TEXT = b"".join(b"line %d of a log, words words words\n" % (i % 97) for i in range(2000))
DATA = {
    "f32": _RNG.standard_normal(20000).astype(np.float32).tobytes(),
    "text": _TEXT,
    "mixed": b"".join(_RNG.choice([b"abc", b"hello", b"\x00\x01\x02", _RNG.bytes(5)])
                      for _ in range(8000)),
    "large": _RNG.standard_normal(50000).astype(np.float32).tobytes() + _TEXT,  # > 128 KB
    "random": _RNG.bytes(30000),  # incompressible: raw blocks
    "rle": b"\x07" * 40000,
    "zeros": bytes(200000),
    "empty": b"",
}
FLAGS = {"plain": {}, "checksum": {"write_checksum": True},
         "no_size": {"write_content_size": False}}
CASES = [(d, lvl, f) for d in ("f32", "text", "mixed") for lvl in (1, 3, 19) for f in FLAGS] + [
    (d, 3, f) for d in ("large", "random", "rle", "zeros", "empty") for f in ("plain", "checksum")]


def _frame(data: str, level: int, flags: str) -> bytes:
    return zstandard.ZstdCompressor(level=level, **FLAGS[flags]).compress(DATA[data])


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler on this host: the compiled reader is checked on the card")
    out = tmp_path_factory.mktemp("host") / "host_zstd.so"
    src = REPO / "yolopoint_tpu_torch" / "ops" / "csrc" / "host_zstd.cpp"
    subprocess.run([cxx, "-std=c++17", "-O2", "-fPIC", "-shared", "-o", str(out), str(src)],
                   check=True, capture_output=True, timeout=180)
    lib = ctypes.CDLL(str(out))
    for name in ("yp_zstd_decompress", "yp_crc32c"):
        getattr(lib, name).argtypes = _build._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------- zstd

@pytest.mark.parametrize("data,level,flags", CASES, ids=["-".join(map(str, c)) for c in CASES])
def test_zstd_equals_zstandard(data, level, flags, host_lib):
    frame = _frame(data, level, flags)
    assert zstd.decompress(frame) == DATA[data]
    assert zstd.decompress_compiled(frame, lib=host_lib) == DATA[data]


def test_zstd_frames_end_to_end_and_skippable(host_lib):
    skippable = ((zstd.SKIPPABLE_MAGIC + 5).to_bytes(4, "little") + (3).to_bytes(4, "little")
                 + b"xyz")
    data = _frame("text", 1, "checksum") + skippable + _frame("f32", 3, "no_size") + skippable
    want = DATA["text"] + DATA["f32"]
    assert zstd.decompress(data) == want
    assert zstd.decompress_compiled(data, lib=host_lib) == want


def _bad_frames() -> dict:
    good = _frame("mixed", 3, "checksum")
    bad = {f"cut{n}": good[:n] for n in (3, 5, 9, len(good) // 2, len(good) - 1)}
    for i in range(5, len(good), len(good) // 40):  # byte 4 bit 4 is unused
        flipped = bytearray(good)
        flipped[i] ^= 0x10
        bad[f"flip{i}"] = bytes(flipped)
    wrong = bytearray(good)
    wrong[-1] ^= 1  # the checksum itself
    bad["checksum"] = bytes(wrong)
    # dictionary ID flag 1 (one byte, ID 7) in the frame header descriptor
    plain = _frame("text", 1, "plain")
    bad["dictionary"] = plain[:4] + bytes([plain[4] | 1]) + plain[5:6] + b"\x07" + plain[6:]
    bad["empty"] = b""
    bad["magic"] = b"\x00" * 8
    return bad


BAD = _bad_frames()


@pytest.mark.parametrize("name", list(BAD))
def test_zstd_refuses_bad_frames(name, host_lib):
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(BAD[name])
    with pytest.raises(zstd.ZstdError):
        zstd.decompress_compiled(BAD[name], lib=host_lib)


def _content_size_moved(frame: bytes, delta: int) -> bytes:
    """`frame` with the content size of its header moved by `delta`."""
    fhd = frame[4]
    single, fcs_flag = (fhd >> 5) & 1, fhd >> 6
    assert not fhd & 3, "no dictionary ID field"
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    assert fcs_size > 2
    pos = 5 if single else 6
    value = int.from_bytes(frame[pos:pos + fcs_size], "little") + delta
    return frame[:pos] + value.to_bytes(fcs_size, "little") + frame[pos + fcs_size:]


@pytest.mark.parametrize("delta", [-1, 1])
def test_zstd_content_size_must_match(delta, host_lib):
    frame = _content_size_moved(_frame("text", 3, "plain"), delta)
    with pytest.raises(zstd.ZstdError, match="content size|header says"):
        zstd.decompress(frame)
    with pytest.raises(zstd.ZstdError, match="content size|header says"):
        zstd.decompress_compiled(frame, lib=host_lib)


# ------------------------------------------------------------------- CRC-32C

@pytest.mark.parametrize("data,want", [(b"", 0), (b"123456789", 0xE3069283),
                                       (bytes(32), 0x8A9136AA), (b"\xff" * 32, 0x62A8AB43),
                                       (bytes(range(32)), 0x46DD794E)])
def test_crc32c_vectors(data, want, host_lib):
    assert crc32c.crc32c(data) == want
    assert crc32c.crc32c_compiled(data, host_lib) == want


@pytest.mark.parametrize("version", ["n", "s"])
def test_crc32c_of_the_committed_nodes(version, host_lib):
    best = RUNS[version]
    files = [best / "manifest.ocdbt", best / "ocdbt.process_0" / "manifest.ocdbt",
             *(best / "d").iterdir()]
    for path in files:
        raw = path.read_bytes()
        want = int.from_bytes(raw[-4:], "little")
        assert crc32c.crc32c(raw[:-4]) == want, path
        assert crc32c.crc32c_compiled(raw[:-4], host_lib) == want, path


def test_crc_mismatch_raises_naming_the_file(tmp_path):
    best = tmp_path / "best"
    shutil.copytree(RUNS["n"], best)
    raw = bytearray((best / "manifest.ocdbt").read_bytes())
    raw[20] ^= 1
    (best / "manifest.ocdbt").write_bytes(bytes(raw))
    with pytest.raises(orbax_read.OcdbtError, match="manifest.ocdbt.*CRC-32C"):
        orbax_read.OcdbtStore(best, orbax_read.Codec(False))


# --------------------------------------------------------------------- OCDBT

@pytest.mark.parametrize("version", ["n", "s"])
def test_ocdbt_list_equals_tensorstore(version):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{RUNS[version]}"}).result()
    store = orbax_read.OcdbtStore(RUNS[version], orbax_read.Codec(False))
    keys = store.list()
    assert keys == sorted(kv.list().result()) and len(keys) == 1138
    for key in (keys[0], keys[1], keys[-1], b"step/0"):
        assert store.read(key) == kv.read(key).result().value
    with pytest.raises(KeyError):
        store.read(b"params.nothing/0")


def test_ocdbt_deep_tree_equals_tensorstore(tmp_path, host_lib):
    """Interior nodes, inline and indirect values, more versions than the
    manifest holds inline (older ones in version tree nodes), several data
    files."""
    spec = {"driver": "ocdbt", "base": f"file://{tmp_path}",
            "config": {"max_decoded_node_bytes": 300, "max_inline_value_bytes": 16}}
    kv = ts.KvStore.open(spec).result()
    rng = np.random.default_rng(0)
    for commit in range(20):
        with ts.Transaction() as txn:
            for i in range(12):
                key = f"key{commit:02d}/{'x' * (i % 5)}{i:03d}".encode()
                kv.with_transaction(txn).write(key, rng.bytes(int(rng.integers(0, 40)))).result()
    want = sorted(kv.list().result())
    for codec in (orbax_read.Codec(False), orbax_read.Codec(True, host_lib)):
        store = orbax_read.OcdbtStore(tmp_path, codec)
        assert store.root_height > 1
        assert store.list() == want
        for key in want:
            assert store.read(key) == kv.read(key).result().value, key


# ---------------------------------------------------------------------- zarr

def _zarr_meta(**kw) -> dict:
    meta = {"zarr_format": 2, "shape": [7, 9], "chunks": [3, 4], "dtype": "<f4", "order": "C",
            "compressor": {"id": "zstd", "level": 1}, "fill_value": None, "filters": None,
            "dimension_separator": "."}
    meta.update(kw)
    return meta


def test_zarr_chunks_assembled_in_c_order(tmp_path):
    base = {"driver": "ocdbt", "base": f"file://{tmp_path}"}
    want = np.arange(63, dtype=np.float32).reshape(7, 9) * 0.5 - 3
    arr = ts.open({"driver": "zarr", "kvstore": {**base, "path": "a/"},
                   "metadata": _zarr_meta(fill_value=1.5)}, create=True).result()
    arr.write(want).result()
    arr[3:6, 4:8].write(np.full((3, 4), 1.5, np.float32)).result()  # the fill: not stored
    want[3:6, 4:8] = 1.5
    store = orbax_read.OcdbtStore(tmp_path, orbax_read.Codec(False))
    assert b"a/1.1" not in store.list() and b"a/2.2" in store.list()
    got = orbax_read.read_zarr_array(store, "a")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, arr.read().result())


@pytest.mark.parametrize("change,match", [
    ({"filters": [{"id": "delta", "dtype": "<f4"}]}, "filters"),
    ({"compressor": {"id": "blosc"}}, "compressor"),
    ({"order": "F"}, "order"),
    ({"dtype": ">f4"}, "dtype"),
    ({}, "chunk b/0.1 missing")])
def test_zarr_refusals_name_the_array(tmp_path, change, match):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}"}).result()
    kv.write(b"b/.zarray", json.dumps(_zarr_meta(**change)).encode()).result()
    kv.write(b"b/0.0", zstandard.ZstdCompressor().compress(bytes(48))).result()
    store = orbax_read.OcdbtStore(tmp_path, orbax_read.Codec(False))
    with pytest.raises(orbax_read.OcdbtError, match=match):
        orbax_read.read_zarr_array(store, "b")


# ------------------------------------------------------ the committed trees

@pytest.mark.parametrize("version", ["n", "s"])
def test_small_arrays_equal_orbax_and_the_digests(version):
    best = RUNS[version]
    ckpt = orbax_read.OrbaxCheckpoint(best, orbax_read.Codec(False))
    got = {"batch_stats": ckpt.subtree("batch_stats"), "step": ckpt.array(("step",))}
    item = {"batch_stats": got["batch_stats"], "step": 0}
    args = jax.tree_util.tree_map(lambda _: ocp.RestoreArgs(restore_type=np.ndarray), item)
    want = ocp.PyTreeCheckpointer().restore(best, args=ocp.args.PyTreeRestore(
        item=item, restore_args=args, partial_restore=True))  # orbax reads only these
    digests = DIGESTS[best.parent.name]
    flat = jax.tree_util.tree_leaves_with_path(got)
    assert len(flat) == 1 + sum(k.startswith("batch_stats.") for k in digests)
    for path, a in flat:
        key = ".".join(p.key for p in path)
        ref = want
        for p in path:
            ref = ref[p.key]
        ref = np.asarray(ref)
        assert a.dtype == ref.dtype and a.shape == ref.shape and np.array_equal(a, ref), key
        assert digests[key] == {"shape": list(a.shape), "dtype": a.dtype.str,
                                "sha256": hashlib.sha256(a.tobytes()).hexdigest()}, key
    assert got["step"].dtype == np.int64 and got["step"].shape == ()


# ----------------------------------------------------- fresh JAX checkpoints

def test_fresh_checkpoint_end_to_end(tmp_path):
    rng = np.random.default_rng(11)
    x = rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    jmodel = jax_build_model("YOLOPoint", "n", nc=5)
    # seeded weights in the shapes of the JAX init (traced, not run: seconds
    # instead of its eager op-by-op init)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(2), jnp.asarray(x),
                                                train=False))
    variables = randomize_bn(jax.tree_util.tree_map(
        lambda a: (rng.normal(0, 1, a.shape) / np.sqrt(np.prod(a.shape[:-1]) or 1)
                   ).astype(np.float32), shapes), rng)
    tx = make_optimizer(learning_rate=1e-3, lrf=0.1, total_epochs=1, steps_per_epoch=1)
    state = create_train_state(jmodel, jax.random.PRNGKey(0), x.shape, tx=tx,
                               variables=variables, ema=True)
    ema = jax.tree_util.tree_map(
        lambda a: np.asarray(a) * np.float32(1.01) + np.float32(0.003), state.params)
    state = state.replace(ema_params=ema)
    names = [str(i) for i in range(5)]
    mgr = CheckpointManager(tmp_path / "run")
    meta = {"names": names, "version": "n", "model_name": "YOLOPoint"}
    mgr.save(3, state, metadata=meta, fitness=0.5, best=True)
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        {"params": ema, "batch_stats": variables["batch_stats"]}, jnp.asarray(x))
    loaded = load_weights(tmp_path / "run", device="cpu")  # its best/ (the steps: RULES)
    assert {k: loaded["meta"][k] for k in meta} == meta  # best_meta.json of the run
    model = build_model("YOLOPoint", "n", nc=5, device="cpu")
    model.load_state_dict(loaded["state_dict"])  # strict
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got["semi"].permute(0, 2, 3, 1).numpy(),
                               np.asarray(want["semi"]), rtol=0, atol=TOL)
    np.testing.assert_allclose(got["desc"].permute(0, 2, 3, 1).numpy(),
                               np.asarray(want["desc"]), rtol=0, atol=TOL)
    for g, w in zip(got["objects"], want["objects"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL)


class _State:
    """The fields of a train state that the JAX `CheckpointManager` saves."""

    def __init__(self, value: float, step: int, ema: bool = True):
        self.params = {"m_0": {"conv": {"kernel": np.full((1, 1, 2, 3), value, np.float32)}}}
        self.batch_stats = {"m_0": {"bn": {"mean": np.full(3, value + 0.5, np.float32)}}}
        self.ema_params = ({"m_0": {"conv": {"kernel": np.full((1, 1, 2, 3), value + 0.25,
                                                                np.float32)}}}
                           if ema else None)
        self.opt_state = ()
        self.step = step


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_runs")
    mgr = CheckpointManager(root / "run")
    mgr.save(5, _State(1.0, 5), fitness=0.9, best=True)
    mgr.save(9, _State(2.0, 9))
    mgr.save(10, _State(3.0, 10))
    nobest = CheckpointManager(root / "nobest")
    nobest.save(9, _State(4.0, 9))
    nobest.save(10, _State(5.0, 10))  # newest by number, not by name
    CheckpointManager(root / "noema").save(1, _State(6.0, 1, ema=False), best=True)
    return root


# path, prefer_ema, the directory the JAX rule reads, the value of its params
RULES = [("run", True, "run/best", 1.25), ("run/best", True, "run/best", 1.25),
         ("run", False, "run/best", 1.0), ("nobest", True, "nobest/ckpts/10/default", 5.25),
         ("run/ckpts/9", True, "run/ckpts/9/default", 2.25),
         ("noema", True, "noema/best", 6.0)]


@pytest.mark.parametrize("path,prefer_ema,picked,value", RULES,
                         ids=[f"{r[0]}-ema{int(r[1])}" for r in RULES])
def test_directory_rules(runs, path, prefer_ema, picked, value):
    assert orbax_read.resolve_checkpoint(runs / path) == (runs / picked).resolve()
    got = orbax_read.load_jax_run_variables(runs / path, prefer_ema=prefer_ema, device="cpu")
    payload = ocp.StandardCheckpointer().restore((runs / picked).resolve())
    top = "ema_params" if prefer_ema and payload.get("ema_params") else "params"
    want = {"params": payload[top], "batch_stats": payload["batch_stats"]}
    if picked.endswith("best"):  # the JAX loader reads these itself
        jax_want = load_run_variables(runs / path, prefer_ema=prefer_ema)
        jax.tree_util.tree_map(np.testing.assert_array_equal, want, jax_want)
    jax.tree_util.tree_map(np.testing.assert_array_equal, got, want)
    assert float(got["params"]["m_0"]["conv"]["kernel"].flat[0]) == value


def test_directory_that_holds_no_checkpoint_raises(runs, tmp_path):
    (tmp_path / "ckpts").mkdir()
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        orbax_read.resolve_checkpoint(tmp_path)
    with pytest.raises(ValueError, match="neither a run of the port"):
        load_weights(runs / "run" / "ckpts", device="cpu")


class _Tiny(torch.nn.Module):
    """The port's names for `_State`'s tree: `m.0.conv`, `m.0.bn`."""

    def __init__(self):
        super().__init__()
        block = torch.nn.Module()
        block.conv = torch.nn.Conv2d(2, 3, 1, bias=False)
        block.bn = torch.nn.BatchNorm2d(3)
        self.m = torch.nn.ModuleList([block])


def test_entry_points_take_a_jax_run(runs):
    """The detection CLI's loader and the trainer's warm start read a JAX run
    (both raised on one before: they sent every directory to the port's run
    reader)."""
    from yolopoint_tpu_torch.evaluation.detect_cli import load_eval_weights
    from yolopoint_tpu_torch.training.agent import TrainAgent

    state, meta = load_eval_weights(runs / "run", "cpu")
    assert float(state["m.0.conv.weight"].flatten()[0]) == 1.25 and meta["fitness"] == 0.9
    agent = SimpleNamespace(model=_Tiny(), config={}, device=torch.device("cpu"),
                            state=SimpleNamespace(ema_params=None))
    TrainAgent._load_pretrained(agent, str(runs / "run"), seed=0)
    assert torch.equal(agent.model.m[0].conv.weight, torch.full((3, 2, 1, 1), 1.25))
    assert torch.equal(agent.model.m[0].bn.running_mean, torch.full((3,), 1.5))
    assert "m.0.bn.running_var" in agent.pretrained_report["missing_in_source"]
