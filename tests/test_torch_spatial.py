"""`parallel.spatial.spatial_sharded_forward` on gloo worker processes
(`tests/torch_dist.py`) against the JAX package's `spatial_sharded_forward`
on the tests' virtual devices (as `tests/test_spatial_sharding.py` runs it)
and against the whole-image JAX forward, on the CPU in f32, within 1e-4.

Layouts: `(data 1, spatial 2)` on 2 ranks, YOLOPointDet-n and YOLOPoint-n
(its raw Detect levels too) at 128x128, B = 2; `(2, 2)` on 4 ranks,
YOLOPointDet-n at 256x128, B = 2; `(1, 4)` on 4 ranks, YOLOPoint-n at
128x128, one stride-32 row a shard, so SPPF's 5x5 pools reach two shards
away. Every shard edge (a multiple of 32 rows) cuts through the stem's 6x6
stride-2 window: its output row 32k/2 - 1 reads input rows 32k - 4 to
32k + 1. A block that pads the rows itself (`C3MP`'s 2x2 max pool) is
refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_model import randomize_bn
from tests.torch_dist import run_workers
from yolopoint_tpu.models import build_model as jax_build_model
from yolopoint_tpu.parallel.spatial import image_sharding, make_spatial_mesh
from yolopoint_tpu.parallel.spatial import spatial_sharded_forward as jax_spatial
from yolopoint_tpu_torch.models import build_model, jax_variables_to_state_dict
from yolopoint_tpu_torch.models.blocks import C3MP
from yolopoint_tpu_torch.parallel import Mesh, make_spatial_mesh as port_spatial_mesh
from yolopoint_tpu_torch.parallel import spatial_sharded_forward

torch.set_num_threads(1)

CASES = {  # name -> family, ranks, data, (H, W)
    "det_1x2": ("YOLOPointDet", 2, 1, (128, 128)),
    "yolopoint_1x2": ("YOLOPoint", 2, 1, (128, 128)),
    "det_2x2": ("YOLOPointDet", 4, 2, (256, 128)),
    "yolopoint_1x4": ("YOLOPoint", 4, 1, (128, 128)),
}


def nchw(x):
    return np.asarray(x).transpose(0, 3, 1, 2)


@pytest.fixture(scope="module", params=list(CASES))
def case(request, tmp_path_factory):
    family, ranks, data, (H, W) = CASES[request.param]
    rng = np.random.default_rng(len(request.param))
    jmodel = jax_build_model(family, "n", nc=3)
    variables = randomize_bn(jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)),
                                         train=False), rng)
    img = rng.uniform(0, 1, (2, H, W, 3)).astype(np.float32)
    whole = jmodel.apply(variables, jnp.asarray(img), train=False)
    mesh = make_spatial_mesh(jax.devices()[:ranks], data=data)
    sharded = jax_spatial(jmodel, variables, mesh)(
        jax.device_put(jnp.asarray(img), image_sharding(mesh)))
    out = run_workers(ranks, "tests.torch_dist:spatial_worker", {
        "family": family, "nc": 3, "data": data, "images": nchw(img),
        "state_dict": jax_variables_to_state_dict(variables)},
        tmp_path_factory.mktemp(request.param))
    return {"whole": whole, "sharded": sharded, "ranks": out, "data": data, "H": H}


def _maps(out):
    maps = {"semi": nchw(out["semi"]), "desc": nchw(out["desc"])}
    for i, level in enumerate(out.get("objects", [])):
        maps[f"objects{i}"] = np.asarray(level)
    return maps


def _port_maps(out):
    maps = {"semi": out["semi"].numpy(), "desc": out["desc"].numpy()}
    for i, level in enumerate(out.get("objects", [])):
        maps[f"objects{i}"] = level.numpy()
    return maps


def test_gathered_maps_match_jax(case):
    whole, sharded = _maps(case["whole"]), _maps(case["sharded"])
    for r, got in enumerate(case["ranks"]):
        full = _port_maps(got["full"])
        assert set(full) == set(whole)
        for k in whole:
            np.testing.assert_allclose(full[k], whole[k], atol=1e-4, rtol=0, err_msg=(r, k))
            np.testing.assert_allclose(full[k], sharded[k], atol=1e-4, rtol=0, err_msg=(r, k))


def test_each_rank_holds_its_rows(case):
    n = len(case["ranks"])
    spatial = n // case["data"]
    whole = _maps(case["whole"])
    for r, got in enumerate(case["ranks"]):
        d, s = divmod(r, spatial)
        for k, v in _port_maps(got["local"]).items():
            B, h = whole[k].shape[0] // case["data"], whole[k].shape[2] // spatial
            assert v.shape[2] == h and v.shape[0] == B
            np.testing.assert_allclose(v, whole[k][d * B:(d + 1) * B, :, s * h:(s + 1) * h],
                                       atol=1e-4, rtol=0, err_msg=(r, k))


def test_unsupported_windows_and_shapes_raise():
    sp = port_spatial_mesh(Mesh(1, 0, torch.device("cpu")))
    fwd = spatial_sharded_forward(C3MP(3, 8), sp)
    with pytest.raises(NotImplementedError, match="F.pad of the rows"):
        fwd(torch.zeros(1, 3, 64, 64))
    fwd = spatial_sharded_forward(build_model("YOLOPointDet", "n", device="cpu"), sp)
    with pytest.raises(ValueError, match="multiple of 32"):
        fwd(torch.zeros(1, 3, 48, 64))
    with pytest.raises(ValueError, match="must cover"):
        port_spatial_mesh(Mesh(1, 0, torch.device("cpu")), data=2)
