"""Host-side homographic warping for the training data path.

Counterpart of `yolopoint_tpu/data/host_augment.py`. The loader's threads
sample each sample's homographies with numpy (`sample_homography_np`, the
flips composed into H1), warp the base and pair views and build their valid
masks (warp coverage, a zero 1-px rim, ellipse erosion). The device then
runs only what is cheap and differentiable: photometric work after the warp
under a coverage mask, the point and box warps, the label maps and the
losses (`data.augmentation.build_training_views(precomputed=...)`).

Every step is numpy plus one warp, so one seed gives the JAX package's
views bit for bit. The warp, the coverage and the erosion come from
`data.native.host_warp_for(device)`: numpy for a CPU run, compiled host code
(`ops/csrc/host_image.cpp`, called through ctypes, which releases the GIL
so the loader's threads warp in parallel) for a GPU run.

Enable with `data.augmentation.host_warp: true`; the training CLI also
takes this path by default on hosts that can feed it (`training.cli`).
"""

from __future__ import annotations

import functools
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Mapping, Optional

import numpy as np
import torch

from yolopoint_tpu_torch.data.native import HostWarp, host_warp_for
from yolopoint_tpu_torch.ops.geometry import ellipse_kernel
from yolopoint_tpu_torch.ops.homography import sample_homography_np

NORM_SHAPE = np.array([2.0, 2.0])  # with shift -1: homographies on [-1, 1]^2


@functools.lru_cache(maxsize=8)
def _mosaic_canvas_np(full_hw: tuple[int, int], border: int = 2) -> np.ndarray:
    """numpy twin of `data.augmentation.mosaic_canvas_mask` (a loader thread
    queues no device work)."""
    Hf, Wf = full_hw
    m = np.ones((Hf, Wf), np.float32)
    for y in (0, Hf // 2, Hf):
        m[max(y - border, 0):min(y + border, Hf)] = 0.0
    for x in (0, Wf // 2, Wf):
        m[:, max(x - border, 0):min(x + border, Wf)] = 0.0
    return m


def _flip_h(horizontal: bool, vertical: bool) -> np.ndarray:
    f = np.eye(3, dtype=np.float64)
    if horizontal:
        f[0, 0] = -1.0
    if vertical:
        f[1, 1] = -1.0
    return f


def _sample_h(rng: np.random.Generator, params: Mapping[str, Any],
              crop_pts: Optional[dict] = None):
    p = {k: v for k, v in dict(params or {}).items() if k != "cropHW"}
    return sample_homography_np(NORM_SHAPE, shift=-1.0, crop_pts=crop_pts,
                                seed=int(rng.integers(2**31)), **p)


def _zero_rim(m: np.ndarray) -> np.ndarray:
    m[0, :] = 0
    m[-1, :] = 0
    m[:, 0] = 0
    m[:, -1] = 0
    return m


def valid_mask(ops: HostWarp, h: np.ndarray, hw: tuple[int, int], margin: int,
               valid_src: Optional[np.ndarray] = None) -> np.ndarray:
    """The valid mask of a view warped by `h`: its warp coverage (or the
    nearest warp of `valid_src`), the 1-px rim zeroed, then, for the
    coverage only, eroded by the `2 margin` ellipse."""
    if valid_src is None:
        m = ops.coverage(hw, h)
    else:
        m = ops.warp(valid_src.astype(np.float32), h, mode="nearest")
    m = _zero_rim(m)
    if valid_src is None and margin > 0:
        m = ops.erode(m, ellipse_kernel(margin))
    return m


def compose_crop(h_crop: np.ndarray, crop_pts: dict) -> np.ndarray:
    """A crop-frame normalized homography conjugated into the full frame,
    `C @ H @ C^-1` (numpy twin of `data.augmentation.crop_conjugate_homography`)."""
    Hc, Wc = crop_pts["H_crop"], crop_pts["W_crop"]
    Hf, Wf = crop_pts["HW_full"]
    ty, tx = crop_pts["tl"]
    C = np.array([
        [Wc / Wf, 0.0, (2.0 * tx + Wc) / Wf - 1.0],
        [0.0, Hc / Hf, (2.0 * ty + Hc) / Hf - 1.0],
        [0.0, 0.0, 1.0],
    ])
    return C @ h_crop @ np.linalg.inv(C)


def one_image(ops: HostWarp, img, aug_cfg, rng_seed, crop_yx, crop_hw, mosaic_src):
    """Warp one image: `(image_base, valid_base, image_pair, valid_pair, h1,
    h2)`, the precomputed payload of one sample."""
    rng = np.random.default_rng(rng_seed)
    Hf, Wf = img.shape[:2]

    hom_cfg = aug_cfg.get("homographic") or {}
    hom_params = hom_cfg.get("params") or {}
    hom_enabled = bool(hom_cfg.get("enable", False))
    margin = int(hom_cfg.get("valid_border_margin", 0))
    warp_cfg = aug_cfg.get("warped_pair") or {}
    warp_params = warp_cfg.get("params") or hom_params
    if mosaic_src is not None:  # each mosaic override applies on its own
        if mcfg := hom_cfg.get("mosaic"):
            hom_params = mcfg.get("params") or hom_params
        if wm := warp_cfg.get("mosaic_params"):
            warp_params = wm

    # flips are composed into h1; in crop mode that mirrors the content of
    # the crop window, as the device path's mirrored frame and crop corner do
    flip = np.eye(3)
    if flipping := hom_cfg.get("flipping"):
        flip = _flip_h(rng.random() < float(flipping.get("horizontal", 0.0)),
                       rng.random() < float(flipping.get("vertical", 0.0)))

    crop_pts = None
    if crop_yx is not None:
        hc, wc = crop_hw
        crop_pts = {"W_crop": wc, "H_crop": hc, "tl": (crop_yx[0], crop_yx[1]),
                    "HW_full": (Hf, Wf)}

    if hom_enabled or mosaic_src is not None:
        h1 = _sample_h(rng, hom_params, crop_pts)
        if crop_pts is not None:
            h1 = h1[0]  # (h_crop, h_big): h_big is recomputed after the flip
    else:
        h1 = np.eye(3)
    h2 = _sample_h(rng, warp_params)

    h1 = flip @ h1
    h12 = h1 @ h2

    if crop_pts is None:
        if not hom_enabled and mosaic_src is None:
            # the identity base view (flipped or not) has only its rim zeroed
            img_b = img if np.array_equal(h1, np.eye(3)) else ops.warp(img, h1)
            vm_b = _zero_rim(np.ones((Hf, Wf), np.float32))
        else:
            img_b = ops.warp(img, h1)
            vm_b = valid_mask(ops, h1, (Hf, Wf), margin, mosaic_src)
        img_p = ops.warp(img, h12)
        # the pair's mask is the base mask warped by h2, nothing more
        vm_p = ops.warp(vm_b, h2, mode="nearest")
        return img_b, vm_b, img_p, vm_p, h1, h2

    # crop mode: each crop-frame homography conjugated into the full frame,
    # the full image warped, then cropped; the window clamped into the frame
    # as the device path's crop (`lax.dynamic_slice` in the JAX package)
    # clamps it (a corner past `(Hf - hc, Wf - wc)` comes from a dataset mix
    # whose crop size the batch's config does not set; the JAX host path
    # fails there)
    hc, wc = crop_hw
    y0 = min(max(int(crop_yx[0]), 0), Hf - hc)
    x0 = min(max(int(crop_yx[1]), 0), Wf - wc)
    h1_big = compose_crop(h1, crop_pts)
    h12_big = compose_crop(h12, crop_pts)
    img_b = ops.warp(img, h1_big)[y0:y0 + hc, x0:x0 + wc]
    vm_b = valid_mask(ops, h1_big, (Hf, Wf), margin, mosaic_src)[y0:y0 + hc, x0:x0 + wc]
    if mosaic_src is not None:
        # the device path's crop + mosaic branch zeroes the cropped mask's rim
        vm_b = _zero_rim(vm_b.copy())
    img_p = ops.warp(img, h12_big)[y0:y0 + hc, x0:x0 + wc]
    vm_p = ops.warp(vm_b, h2, mode="nearest")
    return img_b, vm_b, img_p, vm_p, h1, h2


def _to_u8(img: np.ndarray) -> np.ndarray:
    # `np.rint` rounds half to even, as the JAX package's payload does
    return np.clip(np.rint(img * 255.0), 0, 255).astype(np.uint8)


def _payload(args) -> tuple:
    """One sample's payload from its frame (u8 scaled to [0, 1] in f32, as
    the JAX package scales the batch), its views and masks as u8; in the
    worker thread, where numpy releases the interpreter lock on whole
    arrays."""
    ops, img, *rest = args
    img = img.astype(np.float32) / 255.0 if img.dtype == np.uint8 else \
        img.astype(np.float32, copy=False)
    img_b, vm_b, img_p, vm_p, h1, h2 = one_image(ops, img, *rest)
    return (_to_u8(img_b), vm_b.astype(np.uint8), _to_u8(img_p), vm_p.astype(np.uint8),
            h1.astype(np.float32), h2.astype(np.float32))


def host_warp_views(
    batch: Mapping[str, Any],
    aug_config: Mapping[str, Any],
    rng: Optional[np.random.Generator],
    executor: Optional[ThreadPoolExecutor] = None,
    device: str | torch.device = "cuda",
    seeds: Optional[np.ndarray] = None,
) -> dict:
    """The collated `batch` with the precomputed-warp payload added:
    `precomputed_{image_base, valid_base, image_pair, valid_pair}` (u8) and
    `precomputed_{h1, h2}` (f32), which `build_training_views(precomputed=...)`
    consumes. `image` becomes a zero-channel stub (the step reads only its
    shape). The samples' seeds are `seeds`, or drawn from `rng` (one
    `integers(2**31, size=B)`), before `executor` (the loader's thread pool,
    or none) warps them. `device` is the device the batch is for: it picks
    the numpy (CPU) or compiled warp."""
    ops = host_warp_for(device)
    images = np.asarray(batch["image"])
    B, Hf, Wf = images.shape[:3]
    mosaic = "mosaic_crop_yx" in batch
    crop_yx = batch.get("mosaic_crop_yx", batch.get("crop_yx"))
    crop_hw = None
    if crop_yx is not None:
        hom_cfg = aug_config.get("homographic") or {}
        crop_hw = (Hf // 2, Wf // 2) if mosaic else tuple(hom_cfg.get("cropHW") or (Hf, Wf))

    mosaic_src = _mosaic_canvas_np((Hf, Wf)) if mosaic else None

    if seeds is None:
        seeds = rng.integers(2**31, size=B)
    args = [(ops, images[i], aug_config, int(seeds[i]),
             None if crop_yx is None else np.asarray(crop_yx[i]), crop_hw, mosaic_src)
            for i in range(B)]
    results = list(executor.map(_payload, args)) if executor is not None else \
        [_payload(a) for a in args]

    out = dict(batch)
    out["image"] = np.zeros((B, Hf, Wf, 0), np.uint8)
    for j, key in enumerate(("image_base", "valid_base", "image_pair", "valid_pair", "h1", "h2")):
        out[f"precomputed_{key}"] = np.stack([r[j] for r in results])
    return out
