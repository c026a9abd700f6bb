"""The serving artifact (`yolopoint_tpu_torch/export/aot.py`) on the CPU: a
`torch.export` program of `InferencePipeline.decode(forward(images))` that
reloads and gives the eager pipeline's outputs bit for bit (f32, and the
CLI's bf16 fused deploy model), and the JAX package's `_process` on the same
weights at `tests/test_torch_pipeline.py`'s tolerances; its graphs hold the
four `yolopoint::` ops (K1 at a radius that tiles the frame, K6 at one that
does not); the CLI writes a loadable artifact; a wrong magic and a wrong
device raise; and the ops count kernel launches when the program runs, not
when it is traced."""

import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_model import randomize_bn
from tests.test_torch_pipeline import CONFIG
from yolopoint_tpu.frontend.pipeline import InferencePipeline as JaxPipeline
from yolopoint_tpu.models import build_model as jax_build_model
from yolopoint_tpu_torch.export import aot, aot_cli
from yolopoint_tpu_torch.frontend import InferencePipeline
from yolopoint_tpu_torch.models import build_model, jax_variables_to_state_dict
from yolopoint_tpu_torch.ops import library

torch.set_num_threads(1)

HW = 128


@pytest.fixture(scope="module")
def weights():
    rng = np.random.default_rng(11)
    jmodel = jax_build_model("YOLOPoint", "n", nc=3)
    variables = randomize_bn(jax.jit(lambda k, x: jmodel.init(k, x, train=False))(
        jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3))), rng)
    images = rng.integers(0, 256, (2, HW, HW, 3), dtype=np.uint8).astype(np.float32) / 255.0
    return jmodel, variables, images


def ops_of(serving):
    return {str(n.target).split(".")[1] for n in serving.program.graph.nodes
            if str(n.target).startswith("yolopoint.")}


def test_round_trip_equals_eager_and_jax(tmp_path, weights):
    jmodel, variables, images = weights
    model = build_model("YOLOPoint", "n", nc=3, device="cpu")
    model.load_state_dict(jax_variables_to_state_dict(variables))
    path = tmp_path / "a.pt2"
    aot.save_serving_artifact(path, model, None, CONFIG, batch=2, height=HW, width=HW,
                              compute_dtype=torch.float32, device="cpu")
    serving = aot.load_serving_artifact(path, device="cpu")
    got = {k: v.numpy() for k, v in serving(images).items()}
    eager = InferencePipeline(model, CONFIG, device="cpu")(torch.from_numpy(images))
    assert set(got) == set(eager)
    for k, v in eager.items():
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)
    assert serving.meta == {"input_shape": [2, HW, HW, 3], "input_dtype": "float32",
                            "config": CONFIG, "device": "cpu"}

    want = {k: np.asarray(v) for k, v in JaxPipeline(jmodel, variables, CONFIG)._process(
        jnp.asarray(images)).items()}
    for b in range(2):
        ok, jok = got["kp_valid"][b], want["kp_valid"][b]
        assert ok.sum() == jok.sum() > 50
        ours = dict(zip(map(tuple, got["keypoints"][b][ok]), got["kp_scores"][b][ok]))
        theirs = dict(zip(map(tuple, want["keypoints"][b][jok]), want["kp_scores"][b][jok]))
        assert ours.keys() == theirs.keys()
        for p, s in theirs.items():
            assert abs(ours[p] - s) <= s * 2.0**-19
        bok, bjok = got["box_valid"][b], want["box_valid"][b]
        assert bok.sum() == bjok.sum() > 0
        order = np.argsort(-got["box_scores"][b][bok], kind="stable")
        jorder = np.argsort(-want["box_scores"][b][bjok], kind="stable")
        assert np.abs(got["boxes"][b][bok][order] - want["boxes"][b][bjok][jorder]).max() <= 1e-3
        jd = dict(zip(map(tuple, want["keypoints"][b][jok]), want["descriptors"][b][jok]))
        for p, d in zip(map(tuple, got["keypoints"][b][ok]), got["descriptors"][b][ok]):
            assert np.abs(d - jd[p]).max() <= 1e-4


@pytest.fixture(scope="module")
def tiled(tmp_path_factory):
    """An f32 artifact at NMS radius 4 (the keys of K1) and one at radius 3
    (64 px is no multiple of 3: K6's map), of a seeded model."""
    tmp = tmp_path_factory.mktemp("aot")
    torch.manual_seed(0)
    model = build_model("YOLOPoint", "n", nc=3, device="cpu")
    paths = []
    for radius in (4, 3):
        path = tmp / f"r{radius}.pt2"
        aot.save_serving_artifact(path, model, None, {"nms": radius}, batch=1, height=64,
                                  width=64, compute_dtype=torch.float32, device="cpu")
        paths.append(path)
    return paths


def test_graphs_hold_the_four_ops(tiled):
    keys, untiled = (aot.load_serving_artifact(p, device="cpu") for p in tiled)
    assert ops_of(keys) == {"nms_tile_keys", "greedy_nms_keep", "sample_descriptors"}
    assert ops_of(untiled) == {"nms_suppressed_map", "greedy_nms_keep", "sample_descriptors"}
    assert ops_of(keys) | ops_of(untiled) == set(library.OPS)


def test_ops_count_launches_at_run_time(tiled, monkeypatch):
    """On a CUDA tensor the op bodies launch the kernels and count; here the
    CPU bodies are the plain versions, so the wrappers are replaced by
    counting stand-ins to show that the program calls them when it runs
    (tracing ran the fake implementations only: none was called then)."""
    from yolopoint_tpu_torch.ops import cuda_box_nms, cuda_gather, cuda_nms

    counts = {}
    for mod, name in ((cuda_nms, "nms_tile_keys"), (cuda_nms, "nms_suppressed_map"),
                      (cuda_box_nms, "greedy_nms_keep"), (cuda_gather, "sample_descriptors_cuda")):
        real = getattr(mod, name)

        def counting(*args, _real=real, _name=name):
            counts[_name] = counts.get(_name, 0) + 1
            return _real(*args)

        monkeypatch.setattr(mod, name, counting)
    for path in tiled:
        aot.load_serving_artifact(path, device="cpu")(torch.rand(1, 64, 64, 3))
    assert counts == {"nms_tile_keys": 1, "nms_suppressed_map": 1, "greedy_nms_keep": 2,
                      "sample_descriptors_cuda": 2}


def test_cli_writes_the_bf16_fused_model(tmp_path):
    """The CLI's default deploy path (BN folded, bf16 fused) equals the eager
    pipeline of the same model bit for bit."""
    from yolopoint_tpu_torch.frontend.pipeline import deploy_model

    out = tmp_path / "cli.pt2"
    aot_cli.main(["--out", str(out), "--model", "YOLOPoint", "--version", "n", "--nc", "4",
                  "--batch", "1", "--height", "64", "--width", "96", "--device", "cpu"])
    serving = aot.load_serving_artifact(out, device="cpu")
    assert serving.input_shape == (1, 64, 96, 3)
    images = np.random.default_rng(0).random((1, 64, 96, 3), np.float32)
    got = serving(images)
    model, dtype, _, _ = deploy_model(None, "YOLOPoint", "n", 4, False)
    assert dtype == torch.bfloat16
    eager = InferencePipeline(model, {}, dtype, device="cpu")(torch.from_numpy(images))
    assert set(got) == set(eager)
    for k, v in eager.items():
        assert torch.equal(got[k], v), k
    assert not [n for n in serving.program.state_dict if ".bn." in n]
    assert all(v.dtype == torch.bfloat16 for k, v in serving.program.state_dict.items()
               if k.endswith("conv.weight"))


def test_wrong_magic_and_device_raise(tmp_path, tiled):
    raw = tiled[0].read_bytes()
    bad = tmp_path / "bad.pt2"
    bad.write_bytes(b"YPTPU1\n" + raw[len(aot.MAGIC):])
    with pytest.raises(ValueError, match="not a yolopoint_tpu_torch serving artifact"):
        aot.load_serving_artifact(bad, device="cpu")
    off = len(aot.MAGIC)
    (hlen,) = struct.unpack_from("<I", raw, off)
    meta = json.loads(raw[off + 4:off + 4 + hlen])
    meta["device"] = "cuda"
    header = json.dumps(meta).encode()
    cuda = tmp_path / "cuda.pt2"
    cuda.write_bytes(aot.MAGIC + struct.pack("<I", len(header)) + header
                     + raw[off + 4 + hlen:])
    with pytest.raises(ValueError, match="exported on cuda, cannot run on cpu"):
        aot.load_serving_artifact(cuda, device="cpu")
