"""The JAX package's random draws, replayed for the PyTorch port's tests.

`jax.random` and `torch.Generator` give different numbers, so the port
splits every random function into a draw and an apply. These helpers make
the same `jax.random.split` and sampling calls, on the same keys and in the
same order, as the JAX functions they name, and return the samples as
torch tensors in the port's draw layout. Feeding them to the port's apply
functions reproduces the JAX package's result.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from yolopoint_tpu.ops.homography import sample_homography_batch


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def photometric_draws(key, shape, params) -> dict:
    """The samples `yolopoint_tpu.data.photometric.photometric_augment(key, ...)` draws."""
    B = shape[0]
    keys = iter(jax.random.split(key, 20))
    d = {}

    def per_image(k, lo, hi):
        return jax.random.uniform(k, (B, 1, 1, 1), minval=lo, maxval=hi)

    def span(p, default):
        val = p.get("value", default) if isinstance(p, dict) else p
        return tuple(val) if isinstance(val, (list, tuple)) else (-val, val)

    if p := params.get("random_brightness"):
        c = p["max_abs_change"] / 255.0
        d["brightness"] = per_image(next(keys), -c, c)
    if p := params.get("random_contrast"):
        d["contrast"] = per_image(next(keys), *p["strength_range"])
    if p := params.get("additive_gaussian_noise"):
        lo, hi = p["stddev_range"]
        d["noise_std"] = per_image(next(keys), lo / 255.0, hi / 255.0)
        d["noise"] = jax.random.normal(next(keys), shape)
    if p := params.get("additive_speckle_noise"):
        d["speckle_prob"] = per_image(next(keys), *p["prob_range"])
        d["speckle_u"] = jax.random.uniform(next(keys), shape[:3])[..., None]
        d["speckle_salt"] = jax.random.uniform(next(keys), shape[:3])[..., None] > 0.5
    if p := params.get("add_elementwise"):
        lo, hi = span(p, (-10, 10))
        d["add_elementwise"] = jax.random.uniform(next(keys), shape, minval=lo / 255.0,
                                                  maxval=hi / 255.0)
    if p := params.get("add"):
        lo, hi = span(p, (-20, 20))
        k1, k2 = jax.random.split(next(keys))
        d["add_do"] = jax.random.bernoulli(k1, 0.5, (B, 1, 1, 1))
        d["add"] = jax.random.uniform(k2, (B, 1, 1, 1), minval=lo / 255.0, maxval=hi / 255.0)
    if p := params.get("channel_shuffle"):
        prob = float(p) if not isinstance(p, dict) else float(p.get("p", 0.5))
        kd, kp = jax.random.split(next(keys))
        d["shuffle_do"] = jax.random.bernoulli(kd, prob, (B,))
        d["shuffle_perm"] = jax.vmap(lambda k: jax.random.permutation(k, shape[-1]))(
            jax.random.split(kp, B))
    if params.get("motion_blur"):
        kd, ko = jax.random.split(next(keys))
        d["motion_do"] = jax.random.bernoulli(kd, 0.5, (B, 1, 1, 1))
        d["motion_horizontal"] = jax.random.bernoulli(ko, 0.5, ())
    if p := params.get("hsv"):
        kh, ks, kv = jax.random.split(next(keys), 3)
        d["hsv"] = [jax.random.uniform(k, (B, 1, 1), minval=1 - a, maxval=1 + a)
                    for k, a in zip((kh, ks, kv), p)]
    if params.get("GaussianBlur"):
        d["blur_do"] = jax.random.bernoulli(next(keys), 0.5, (B, 1, 1, 1))
    if p := params.get("additive_shade"):
        n = int(p.get("nb_ellipses", 20)) if isinstance(p, dict) else 20
        lo, hi = p.get("transparency_range", (-0.5, 0.8)) if isinstance(p, dict) else (-0.5, 0.8)
        k_ax, k_xy, k_ang, k_tr = jax.random.split(next(keys), 4)
        d["shade"] = {
            "axes": jax.random.uniform(k_ax, (B, n, 2)),
            "centers": jax.random.uniform(k_xy, (B, n, 2), minval=0.15, maxval=0.85),
            "angles": jax.random.uniform(k_ang, (B, n), maxval=jnp.pi / 2),
            "transparency": jax.random.uniform(k_tr, (B, 1, 1, 1), minval=lo, maxval=hi),
        }
    return to_torch(d)


def view_shape(shape, config, crop=False, mosaic=False) -> tuple:
    """The `(B, h, w, C)` of the views `build_training_views` makes from
    images of `shape`: the mosaic canvas's centre half, `cropHW` in crop
    mode (a batch with a crop corner), else the frame."""
    B, H, W, C = shape
    if mosaic:
        return B, H // 2, W // 2, C
    if crop:
        return (B, *((config.get("homographic") or {}).get("cropHW") or (H, W)), C)
    return tuple(shape)


def precomputed_view_draws(key, shape, config, crop=False, mosaic=False) -> dict:
    """The samples `build_training_views(key, ..., precomputed=...)` draws
    (`_views_from_precomputed`): the photometric passes at the view's shape,
    the light pass's shared by both views."""
    k_ph_light, k_ph1, k_ph2 = jax.random.split(key, 3)
    phot = config.get("photometric") or {}
    pair = config.get("warped_pair") or {}
    out = {}
    if phot.get("enable", False):
        vshape = view_shape(shape, config, crop or mosaic, mosaic)
        params = phot.get("params") or {}
        if phot.get("params_light") is not None:
            out["phot_light"] = photometric_draws(k_ph_light, vshape, phot["params_light"] or {})
        out["phot_base"] = photometric_draws(k_ph1, vshape, params)
        pair_params = (pair.get("photometric") or {}).get("params") or params
        out["phot_pair"] = photometric_draws(k_ph2, vshape, pair_params)
    return out


def training_view_draws(key, shape, config, crop=False, mosaic=False,
                        precomputed=False) -> dict:
    """The samples `yolopoint_tpu.data.augmentation.build_training_views(key, ...)` draws,
    `crop` when the batch has a crop corner, `mosaic` for a mosaic batch,
    `precomputed` for a host-warped batch (`shape` then carries the views'
    channels)."""
    if precomputed:
        return precomputed_view_draws(key, shape, config, crop, mosaic)
    B = shape[0]
    k_ph_light, k_ph1, k_ph2, k_hom1, k_hom2, k_flip = jax.random.split(key, 6)
    phot = config.get("photometric") or {}
    hom = config.get("homographic") or {}
    pair = config.get("warped_pair") or {}
    hom_params = hom.get("params") or {}
    if mosaic and (m := hom.get("mosaic")):
        hom_params = m.get("params") or hom_params
    pair_hom = pair.get("params") or hom_params
    if mosaic and (m := pair.get("mosaic_params")):
        pair_hom = m
    d = {}
    if flipping := hom.get("flipping"):
        kh, kv = jax.random.split(k_flip)
        h, v = float(flipping.get("horizontal", 0.0)), float(flipping.get("vertical", 0.0))
        d["flip"] = (jax.random.bernoulli(kh, h, (B,)) if h else jnp.zeros(B, bool),
                     jax.random.bernoulli(kv, v, (B,)) if v else jnp.zeros(B, bool))
    out = to_torch(d)
    if phot.get("enable", False):
        params = phot.get("params") or {}
        if phot.get("params_light") is not None:
            out["phot_light"] = photometric_draws(k_ph_light, shape, phot["params_light"] or {})
        out["phot_base"] = photometric_draws(k_ph1, shape, params)
        pair_params = (pair.get("photometric") or {}).get("params") or params
        out["phot_pair"] = photometric_draws(k_ph2, view_shape(shape, config, crop or mosaic,
                                                               mosaic), pair_params)
    if hom.get("enable", False) or mosaic:
        out["h1"] = to_torch(sample_homography_batch(k_hom1, B, **hom_params))
    out["h2"] = to_torch(sample_homography_batch(k_hom2, B, **pair_hom))
    return out


def descriptor_draws(key, batch, hc, wc, num_samples, num_neg, group=128) -> dict:
    """The samples `descriptor_loss_sparse` / `infonce_loss` draw from `key`."""
    k_coords, k_neg = jax.random.split(key)
    kx, ky = jax.random.split(k_coords)
    xs = jax.random.randint(kx, (batch, num_samples), 0, wc)
    ys = jax.random.randint(ky, (batch, num_samples), 0, hc)
    n = batch * num_samples
    G = math.ceil(n / group)
    neg = jax.random.randint(k_neg, (G, num_neg), 0, n)
    return {"uv_a": to_torch(jnp.stack([xs, ys], -1).astype(jnp.float32)),
            "neg_idx": to_torch(neg).long()}


def _step_draws(k_aug, k_desc, shape, aug_config, weights, cell, crop, mosaic,
                precomputed=False) -> dict:
    draws = {"aug": training_view_draws(k_aug, shape, aug_config, crop, mosaic, precomputed)}
    if weights.joint_training:
        # the descriptor loss draws its cells over the view's (crop's) map
        _, h, w, _ = view_shape(shape, aug_config, crop or mosaic, mosaic)
        draws["desc"] = descriptor_draws(k_desc, shape[0], h // cell, w // cell,
                                         weights.num_samples_per_image,
                                         weights.num_masked_non_matches_per_match)
    return draws


def train_step_draws(rng, shape, aug_config, weights, cell=8, crop=False, mosaic=False,
                     precomputed=False, replica=0) -> dict:
    """The samples one `make_train_step` step draws from `rng` on data-parallel
    replica `replica` (its `fold_in(rng, axis_index)`; 0 on one device), for
    that replica's rows of `shape`."""
    k_aug, k_desc = jax.random.split(jax.random.fold_in(rng, replica))
    return _step_draws(k_aug, k_desc, shape, aug_config, weights, cell, crop, mosaic,
                       precomputed)


def val_step_draws(rng, shape, aug_config, weights, cell=8, crop=False, mosaic=False,
                   precomputed=False) -> dict:
    """The samples one `make_val_step` step draws from `rng`."""
    k_aug, k_desc = jax.random.split(rng)
    return _step_draws(k_aug, k_desc, shape, aug_config, weights, cell, crop, mosaic,
                       precomputed)
