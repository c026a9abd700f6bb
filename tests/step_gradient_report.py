"""How far the port's train-step gradients are from the JAX package's, and
how far the JAX package's are from its own under another compilation, on
the CPU at the step test's size (YOLOPoint-n, 128x128, B=2, f32):

    python -m tests.step_gradient_report

For the main batch of `tests/test_torch_train_step.py` (seed 5, key 14),
the batch of seed 1 (key 10) and the same with its kink candidate's box
nudged, one micro-step from the same weights gives, per line, the worst
per-tensor gradient difference (norm of the difference over the norm) of:
the port against the JAX step; the JAX step against itself compiled with
`xla_backend_optimization_level=0`; the port against itself with oneDNN
convolutions off; and the smallest CIoU kink margin of the port's
candidates (grid units). Compiling the JAX step twice takes minutes.

`--crop` reports the port against the JAX step and the JAX step against
itself for the crop and mosaic batches of `tests/test_torch_crop_step.py`:
its smooth frames (the batches its tests use), and the same seeds and the
next with uniform-noise frames, where the views move with every ulp of the
warp's coordinates.
"""

import copy
import sys

import jax
import jax.numpy as jnp
import torch

import tests.conftest  # noqa: F401  (JAX on the CPU, the persistent compile cache)
import tests.test_torch_train_step as T


def worst(got: dict, ref: dict) -> tuple[float, str]:
    def arr(x):
        return x.numpy() if torch.is_tensor(x) else x

    return max((T.rel_norm(arr(got[n]), arr(ref[n])), n) for n in ref)


def crop_report() -> None:
    import numpy as np
    from jax.sharding import Mesh

    import tests.test_torch_crop_step as C
    from yolopoint_tpu.losses.objects import ObjectLossConfig as JCfg
    from yolopoint_tpu.models import build_model as jax_build_model
    from yolopoint_tpu.training import state as jstate
    from yolopoint_tpu.training import step as jstep
    from tests.test_torch_model import randomize_bn

    jmodel = jax_build_model("YOLOPoint", "n", nc=C.NC)
    var = randomize_bn(jax.jit(lambda k, x: jmodel.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))), np.random.default_rng(0))
    cases = [(mode, seed, noise) for noise in (False, True) for mode in ("crop", "mosaic")
             for seed in ((C.SEEDS[mode],) if not noise else (C.SEEDS[mode], C.SEEDS[mode] + 1))]
    for mode, seed, noise in cases:
        run = C.micro_steps((jmodel, var), mode, seed, noise)
        batch, key = C.make_batch(seed, mode, noise), jax.random.PRNGKey(20 + seed)
        jst = jstate.create_train_state(jmodel, jax.random.PRNGKey(0), (1, *C.VIEW, 3),
                                        tx=jstate.make_optimizer(**C.OPT),
                                        variables=copy.deepcopy(var), ema=True)
        jfn = jstep.make_train_step(jmodel, Mesh(np.array(jax.devices()[:1]), ("data",)), C.AUG,
                                    jstep.rescale_yolo_gains(JCfg(**C.OBJ), C.NC, C.VIEW[0]),
                                    jstep.LossWeights(**C.WEIGHTS), C.NC, donate=False, accum=2)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        o0 = jfn.lower(jst, jb, key).compile(
            compiler_options={"xla_backend_optimization_level": 0})
        s0, _ = o0(jst, jb, key)
        g0 = C.to_sd({"params": s0.opt_state.acc_grads})
        frames = "noise" if noise else "smooth"
        print(f"{mode}, seed {seed}, {frames} frames: port vs JAX "
              f"{worst(run['t_grads'], run['j_grads'])}; "
              f"JAX vs JAX at opt level 0 {worst(g0, run['j_grads'])}", flush=True)


def main() -> None:
    if "--crop" in sys.argv[1:]:
        return crop_report()
    side = T.make_jax_side()
    batches = {"seed 5, key 14": (T.make_batch(5), 14),
               "seed 1, key 10": (T.seed1_batch(False), T.SEED1_KEY),
               "seed 1, key 10, nudged": (T.seed1_batch(True), T.SEED1_KEY)}
    step_o0 = None
    for name, (batch, k) in batches.items():
        key = jax.random.PRNGKey(k)
        draws = T.train_step_draws(key, (T.B, T.HW, T.HW, 3), T.AUG, T.tstep.LossWeights(**T.WEIGHTS))
        if step_o0 is None:
            jb = {k_: jnp.asarray(v) for k_, v in batch.items()}
            step_o0 = side["step"].lower(side["state"], jb, key).compile(
                compiler_options={"xla_backend_optimization_level": 0})
        run = T.first_micro_step(side, batch, key, draws)
        run_o0 = T.first_micro_step(side, batch, key, draws, jax_step=step_o0)
        torch.backends.mkldnn.enabled = False
        run_off = T.first_micro_step(side, batch, key, draws)
        torch.backends.mkldnn.enabled = True
        print(f"{name}: port vs JAX {worst(run['t_grads'], run['j_grads'])}; "
              f"JAX vs JAX at opt level 0 {worst(run_o0['j_grads'], run['j_grads'])}; "
              f"port vs port without oneDNN {worst(run_off['t_grads'], run['t_grads'])}; "
              f"smallest kink margin {float(T.kink_margins(run).min()):.3g}", flush=True)


if __name__ == "__main__":
    main()
