"""The train step on crop and mosaic batches (KITTI's device crop and its
mosaic canvas) against `yolopoint_tpu.training.step.make_train_step`, on
the CPU in f32, with the JAX package's own draws replayed
(`tests/torch_replay.py`): YOLOPoint-n, B=2, 128x128 views (a crop of a
160x192 frame; the centre of a 256x256 mosaic canvas) of smooth
camera-like frames, the flagship loss selection, accum 2.

In crop and mosaic mode the views, and the descriptor map whose cells the
descriptor loss samples, are the crop's: the JAX loss takes `(Hc, Wc)` from
the descriptor map of the view (`yolopoint_tpu/losses/descriptor.py:60,75`).
`test_agent_draws_cells_on_the_crop` holds `TrainAgent.step`'s draws to
that map.

Tolerances as `tests/test_torch_train_step.py`: every loss term 1e-4
relative, gradients 1e-3 relative per tensor (the norm of the difference
over the norm), BatchNorm running statistics 1e-5 absolute plus 1e-5
relative.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tests.test_torch_model import randomize_bn
from tests.test_torch_train_step import LOSS_KEYS, OBJ, OPT, WEIGHTS, rel_norm, to_sd
from tests.test_torch_train_step import AUG as S640_AUG
from tests.torch_replay import train_step_draws
from yolopoint_tpu.losses.objects import ObjectLossConfig as JCfg
from yolopoint_tpu.models import build_model as jax_build_model
from yolopoint_tpu.training import state as jstate
from yolopoint_tpu.training import step as jstep
from yolopoint_tpu_torch.losses.objects import ObjectLossConfig
from yolopoint_tpu_torch.models import build_model, jax_variables_to_state_dict
from yolopoint_tpu_torch.training import TrainAgent
from yolopoint_tpu_torch.training import state as tstate
from yolopoint_tpu_torch.training import step as tstep

torch.set_num_threads(1)

NC, B, VIEW = 3, 2, (128, 128)
FRAME = (160, 192)  # the crop batch's full frame
AUG = copy.deepcopy(S640_AUG)
AUG["homographic"].update({
    "cropHW": list(VIEW), "flipping": {"horizontal": 0.5},
    # configs/kitti.yaml's gentler mosaic warp
    "mosaic": {"params": {"perspective": True, "scaling": True, "rotation": True,
                          "translation": True, "patch_ratio": 0.85, "max_angle": 0.3}}})
AUG["warped_pair"]["mosaic_params"] = {"patch_ratio": 0.9, "max_angle": 0.2}


def smooth_images(rng, H: int, W: int) -> np.ndarray:
    """uint8 `(B, H, W, 3)` camera-like frames: a random 8-pixel grid of
    colours, bilinearly upsampled. (Uniform noise, the train-step test's
    input, has a full-range edge at every pixel, so an ulp of a warp
    coordinate moves a view's pixel by up to 3e-5; on such crop and mosaic
    batches the JAX step against itself at another XLA optimization level
    differs by 1e-3 and more, as much as the port does, and this file's
    tolerances could not tell the two apart: `python -m
    tests.step_gradient_report --crop`.)"""
    coarse = torch.from_numpy(rng.uniform(0, 255, (B, 3, H // 8 + 1, W // 8 + 1)))
    img = torch.nn.functional.interpolate(coarse, size=(H, W), mode="bilinear",
                                          align_corners=True)
    return img.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).numpy().copy()


def make_batch(seed: int, mode: str, noise: bool = False) -> dict:
    """A uint8 batch at the mode's frame (the mosaic canvas is twice the
    view) with its crop key: a random corner, or the canvas's centre.
    `noise`: uniform noise in place of the smooth frames."""
    rng = np.random.default_rng(seed)
    H, W = (2 * VIEW[0], 2 * VIEW[1]) if mode == "mosaic" else FRAME
    boxes = np.concatenate([rng.integers(0, NC, (B, 6, 1)), rng.uniform(0.3, 0.7, (B, 6, 2)),
                            rng.uniform(0.1, 0.3, (B, 6, 2))], -1).astype(np.float32)
    image = rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8) if noise else \
        smooth_images(rng, H, W)
    batch = {"image": image,
             "points": rng.uniform(0, min(H, W) - 1, (B, 40, 2)).astype(np.float32),
             "point_mask": np.ones((B, 40), bool), "boxes": boxes,
             "box_mask": np.ones((B, 6), bool)}
    if mode == "mosaic":
        batch["mosaic_crop_yx"] = np.tile(np.array([[H // 4, W // 4]], np.float32), (B, 1))
    else:
        batch["crop_yx"] = np.stack([rng.integers(0, H - VIEW[0] + 1, B),
                                     rng.integers(0, W - VIEW[1] + 1, B)], 1).astype(np.float32)
    return batch


def test_agent_draws_cells_on_the_crop():
    """`TrainAgent.step` draws the descriptor loss's cells over the crop's
    `(hc // 8, wc // 8)` map (the mosaic's `(H // 16, W // 16)`), not the
    full frame's."""
    seen = []

    class Agent:  # the attributes `TrainAgent.step` reads
        gen = torch.Generator().manual_seed(0)
        aug_config, state = AUG, None
        weights = tstep.LossWeights(num_samples_per_image=4000)

        def to_device(self, batch):
            return {k: torch.from_numpy(v) for k, v in batch.items()}

        def train_step(self, state, batch, draws, on_phase=None):
            seen.append(draws)

    for mode in ("crop", "mosaic"):
        TrainAgent.step(Agent(), make_batch(0, mode))
    for draws in seen:
        uv = draws["desc"]["uv_a"]
        assert uv.shape == (B, 4000, 2)
        # the view is 128x128 in both modes: 16x16 cells
        assert int(uv[..., 0].max()) == 15 and int(uv[..., 1].max()) == 15, uv.amax((0, 1))
        assert draws["aug"]["phot_pair"]["noise"].shape == (B, *VIEW, 3)


@pytest.fixture(scope="module")
def variables():
    jmodel = jax_build_model("YOLOPoint", "n", nc=NC)
    init = jax.jit(lambda k, x: jmodel.init(k, x, train=False))
    return jmodel, randomize_bn(init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))),
                                np.random.default_rng(0))


# each mode's batch seed; its key is 20 + seed
SEEDS = {"crop": 3, "mosaic": 3}


def micro_steps(variables, mode: str, seed: int | None = None, noise: bool = False) -> dict:
    """The first micro-step of both packages on the mode's batch."""
    jmodel, var = variables
    seed = SEEDS[mode] if seed is None else seed
    batch, key = make_batch(seed, mode, noise), jax.random.PRNGKey(20 + seed)
    jst = jstate.create_train_state(jmodel, jax.random.PRNGKey(0), (1, *VIEW, 3),
                                    tx=jstate.make_optimizer(**OPT),
                                    variables=copy.deepcopy(var), ema=True)
    jfn = jstep.make_train_step(jmodel, Mesh(np.array(jax.devices()[:1]), ("data",)), AUG,
                                jstep.rescale_yolo_gains(JCfg(**OBJ), NC, VIEW[0]),
                                jstep.LossWeights(**WEIGHTS), NC, donate=False, accum=2)
    s, aux = jfn(jst, {k: jnp.asarray(v) for k, v in batch.items()}, key)

    model = build_model("YOLOPoint", "n", nc=NC, device="cpu")
    model.load_state_dict(jax_variables_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jax.device_get(var))))
    opt = tstate.make_optimizer(model, **OPT)
    tst = tstate.create_train_state(model, opt, ema=True)
    tfn = tstep.make_train_step(model, AUG, tstep.rescale_yolo_gains(
        ObjectLossConfig(**OBJ), NC, VIEW[0]), tstep.LossWeights(**WEIGHTS), NC, accum=2)
    draws = train_step_draws(key, batch["image"].shape, AUG, tstep.LossWeights(**WEIGHTS),
                             crop=True, mosaic=mode == "mosaic")
    t_aux = tfn(tst, {k: torch.from_numpy(v) for k, v in batch.items()}, draws)
    return {"j_aux": {k: float(v) for k, v in aux.items()},
            "t_aux": {k: float(v) for k, v in t_aux.items()},
            "j_grads": to_sd({"params": s.opt_state.acc_grads}),
            "t_grads": {n: a.clone() for n, a in zip(opt.names, opt.acc)},
            "j_stats": to_sd({"params": s.params, "batch_stats": s.batch_stats}),
            "t_stats": {n: b.clone() for n, b in model.named_buffers()}}


@pytest.fixture(scope="module", params=["crop", "mosaic"])
def run(request, variables):
    return micro_steps(variables, request.param)


def test_micro_step_losses_match_jax(run):
    for k in LOSS_KEYS:
        ref, got = run["j_aux"][k], run["t_aux"][k]
        assert abs(got - ref) <= 1e-4 * max(abs(ref), 1e-6), (k, got, ref)
    assert run["t_aux"]["loss_desc"] > 0 and run["t_aux"]["nonfinite_skip"] == 0.0


def test_micro_step_gradients_match_jax(run):
    ref, got = run["j_grads"], run["t_grads"]
    assert set(ref) == set(got)
    worst = max((rel_norm(got[n].numpy(), ref[n]), n) for n in ref)
    assert worst[0] <= 1e-3, worst


def test_micro_step_batchnorm_statistics_match_jax(run):
    names = [n for n in run["j_stats"] if n.endswith(("running_mean", "running_var"))]
    assert names
    for n in names:
        np.testing.assert_allclose(run["t_stats"][n].numpy(), run["j_stats"][n], atol=1e-5,
                                   rtol=1e-5, err_msg=n)
