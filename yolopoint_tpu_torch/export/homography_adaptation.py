"""Pseudo-label export by homographic adaptation.

Counterpart of `homography_adaptation_batch` and `export_pseudo_labels` in
`yolopoint_tpu/export/homography_adaptation.py`: for each image, N
homographies (the first the identity), the N warped views through the
model, each view's heatmap masked to its valid pixels and warped back to
the image, and the masked mean over the views; keypoint NMS and top-k on
that aggregate give the labels, saved as `{name}.npz` with `pts (K, 3)
[x, y, prob]` (the reference export schema).

On the GPU the three image warps (the views; the heatmaps and the masks
back) are the warp kernel K4 (`ops/cuda_warp.py`) and the keypoint NMS of
the aggregate is K1 (or K6 where no NMS tile divides the image). The
homographies come from a `torch.Generator` (the numbers differ from the
JAX package's `jax.random` draws; the distribution is the same), or are
given (`homographies`) to reproduce another run's draws.

`homography_adaptation_host` is the JAX package's host twin: homographies
from a numpy `Generator` (`sample_homography_np`, the JAX draws for the
same seed), views and masks warped on the host (`data.host_augment`), the
forwards on the device chunk by chunk, the heatmaps and masks warped back
on the host into f64 sums, and the keypoint NMS of the aggregate on the
device. `export_pseudo_labels` takes it where the device is not the card
(`default_host_warp`), as the JAX export takes it off the TPU.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from yolopoint_tpu_torch.data.host_augment import NORM_SHAPE, valid_mask
from yolopoint_tpu_torch.data.native import host_warp_for
from yolopoint_tpu_torch.ops.geometry import compute_valid_mask, warp_image
from yolopoint_tpu_torch.ops.heatmap import cells_to_heatmap
from yolopoint_tpu_torch.ops.homography import sample_homography_batch, sample_homography_np
from yolopoint_tpu_torch.ops.keypoints import extract_keypoints


def draw_homographies(gen: torch.Generator, num_homographies: int,
                      hom_params: Optional[Mapping[str, Any]] = None) -> torch.Tensor:
    """`(N, 3, 3)` f32 homographies on the generator's device: the identity,
    then `N - 1` draws of `sample_homography_batch`."""
    draws = sample_homography_batch(gen, num_homographies - 1, **dict(hom_params or {}))
    eye = torch.eye(3, dtype=draws.dtype, device=draws.device)[None]
    return torch.cat([eye, draws], dim=0)


def image_generator(seed: int, index: int, device) -> torch.Generator:
    """The generator of image `index` of an export seeded with `seed`."""
    state = np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def aggregate_heatmap(model: torch.nn.Module, image: torch.Tensor, homographies: torch.Tensor,
                      erosion_radius: int = 3,
                      on_phase: Optional[Callable[[str], None]] = None) -> torch.Tensor:
    """The `(H, W)` f32 aggregate of the views of `image` `(H, W, C)` (float
    in [0, 1], on the model's device) under `homographies` `(N, 3, 3)`
    (output -> source, normalized coordinates): the mean over the views of
    each view's heatmap warped back, weighted by its warped-back valid mask.
    `on_phase(name)` is called after the views ("views"), the forward
    ("forward"), the heatmaps ("heatmap") and the warps back ("warps_back")."""
    H, W, C = image.shape
    N = homographies.shape[0]
    mark = on_phase or (lambda name: None)
    inv = torch.linalg.inv(homographies)
    views = warp_image(image.to(torch.float32).expand(N, H, W, C).contiguous(), homographies)
    masks = compute_valid_mask((H, W), homographies, erosion_radius=erosion_radius)
    mark("views")
    out = model(views.permute(0, 3, 1, 2))
    mark("forward")
    heat = cells_to_heatmap(out["semi"].float().permute(0, 2, 3, 1)) * masks
    mark("heatmap")
    heat_back = warp_image(heat[..., None].contiguous(), inv)[..., 0]
    mask_back = warp_image(masks[..., None].contiguous(), inv)[..., 0]
    mark("warps_back")
    return heat_back.sum(dim=0) / mask_back.sum(dim=0).clamp(min=1e-6)


@torch.inference_mode()
def homography_adaptation_batch(
    model: torch.nn.Module,
    image: torch.Tensor,
    gen: Optional[torch.Generator] = None,
    homographies: Optional[torch.Tensor] = None,
    num_homographies: int = 100,
    conf_thresh: float = 0.015,
    nms_radius: int = 4,
    top_k: int = 1000,
    hom_params: Optional[Mapping[str, Any]] = None,
    erosion_radius: int = 3,
    on_phase: Optional[Callable[[str], None]] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Keypoints of one image by homographic adaptation.

    Args:
      image: `(H, W, C)` float image in [0, 1] on the model's device.
      gen: draws the `num_homographies - 1` random homographies
        (`draw_homographies`); not used when `homographies` is given.
      homographies: `(N, 3, 3)` homographies to use as they are (the first
        should be the identity).
      on_phase: see `aggregate_heatmap`; also called first ("start") and
        after the NMS and top-k ("aggregate_nms").

    Returns:
      `(points (top_k, 2), scores (top_k,), valid (top_k,))` on the device.
    """
    mark = on_phase or (lambda name: None)
    mark("start")
    if homographies is None:
        homographies = draw_homographies(gen, num_homographies, hom_params)
    homographies = homographies.to(device=image.device, dtype=torch.float32)
    agg = aggregate_heatmap(model, image, homographies, erosion_radius, on_phase)
    pts, scores, valid = extract_keypoints(agg[None], conf_thresh, nms_radius, top_k)
    mark("aggregate_nms")
    return pts[0], scores[0], valid[0]


def host_homographies(rng: np.random.Generator, num_homographies: int,
                      hom_params: Optional[Mapping[str, Any]] = None) -> np.ndarray:
    """`(N, 3, 3)` float64 homographies of the host path: the identity, then
    `N - 1` draws of `sample_homography_np`, each seeded from `rng`."""
    params = dict(hom_params or {})
    return np.stack([np.eye(3)] + [
        sample_homography_np(NORM_SHAPE, shift=-1.0, seed=int(rng.integers(2**31)), **params)
        for _ in range(num_homographies - 1)])


@torch.inference_mode()
def aggregate_heatmap_host(model: torch.nn.Module, image: np.ndarray, homographies: np.ndarray,
                           erosion_radius: int = 3, chunk: int = 25,
                           on_phase: Optional[Callable[[str], None]] = None) -> np.ndarray:
    """The `(H, W)` f32 aggregate of `aggregate_heatmap` with the warps on
    the host (numpy on a CPU run, compiled host code on a GPU run): the
    views and their valid masks warped on the host, the forwards on the
    model's device `chunk` views at a time (all queued before the first
    heatmaps are read back), each heatmap and mask warped back on the host
    into f64 sums. `on_phase` is called after the views ("views"), the
    queued forwards ("forward") and the warps back ("warps_back")."""
    mark = on_phase or (lambda name: None)
    device = next(model.parameters()).device
    ops = host_warp_for(device)
    H, W = image.shape[:2]
    image = np.asarray(image, np.float32)
    Hs = np.asarray(homographies, np.float64)
    views = np.stack([ops.warp(image, h) for h in Hs])
    masks = np.stack([valid_mask(ops, h, (H, W), erosion_radius) for h in Hs])
    mark("views")
    heats = []
    for c in range(0, len(Hs), chunk):
        x = torch.from_numpy(views[c:c + chunk]).to(device).permute(0, 3, 1, 2)
        heats.append(cells_to_heatmap(model(x)["semi"].float().permute(0, 2, 3, 1)))
    mark("forward")
    acc = np.zeros((H, W), np.float64)
    macc = np.zeros((H, W), np.float64)
    for ci, heat in enumerate(heats):
        heat = heat.cpu().numpy()
        for j in range(heat.shape[0]):
            i = ci * chunk + j
            hinv = np.linalg.inv(Hs[i])
            acc += ops.warp(heat[j] * masks[i], hinv)
            macc += ops.warp(masks[i], hinv)  # bilinear, as the device path warps it
    mark("warps_back")
    return (acc / np.maximum(macc, 1e-6)).astype(np.float32)


def homography_adaptation_host(
    model: torch.nn.Module,
    image: np.ndarray,
    rng: Optional[np.random.Generator] = None,
    homographies: Optional[np.ndarray] = None,
    num_homographies: int = 100,
    conf_thresh: float = 0.015,
    nms_radius: int = 4,
    top_k: int = 1000,
    hom_params: Optional[Mapping[str, Any]] = None,
    erosion_radius: int = 3,
    chunk: int = 25,
    on_phase: Optional[Callable[[str], None]] = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Keypoints of one image by homographic adaptation with the warps on
    the host (`aggregate_heatmap_host`); the keypoint NMS of the aggregate
    runs on the model's device.

    Args:
      image: `(H, W, C)` float numpy image in [0, 1].
      rng: draws the homographies (`host_homographies`); not used when
        `homographies` `(N, 3, 3)` is given.
      on_phase: see `aggregate_heatmap_host`; also called after the NMS
        and top-k ("aggregate_nms").

    Returns:
      `(points (top_k, 2), scores (top_k,), valid (top_k,))` as numpy.
    """
    device = next(model.parameters()).device
    if homographies is None:
        homographies = host_homographies(rng, num_homographies, hom_params)
    agg = aggregate_heatmap_host(model, image, homographies, erosion_radius, chunk, on_phase)
    with torch.inference_mode():
        pts, scores, valid = extract_keypoints(torch.from_numpy(agg)[None].to(device),
                                               conf_thresh, nms_radius, top_k)
    if on_phase is not None:
        on_phase("aggregate_nms")
    return pts[0].cpu().numpy(), scores[0].cpu().numpy(), valid[0].cpu().numpy()


def default_host_warp(device: torch.device) -> bool:
    """Whether an export on `device` warps on the host by default: where the
    device is not the card (the JAX export warps on the host off the TPU,
    the chip with a warp kernel of its own)."""
    return torch.device(device).type != "cuda"


def export_pseudo_labels(
    model: torch.nn.Module,
    images,
    output_dir: str | Path,
    seed: int = 0,
    normalize_points: bool = False,
    homographies=None,
    host_warp: Optional[bool] = None,
    **ha_kwargs,
) -> list[Path]:
    """Adapt each of `images` (a `{name: image}` mapping or a `(name, image)`
    iterable of `(H, W, C)` float numpy images in [0, 1]) and save
    `{name}.npz` with `pts (K, 3) [x, y, prob]`.

    On the device path (`homography_adaptation_batch`) image `i` draws its
    homographies from its own generator, seeded from `(seed, i)`
    (`image_generator`), on the model's device. On the host path
    (`homography_adaptation_host`; `host_warp`, by default
    `default_host_warp` of the model's device) all images draw from one
    `np.random.default_rng(seed)`, as the JAX export's host path does.
    `homographies`, a sequence of `(N, 3, 3)` per image, replaces the draws.
    `ha_kwargs` go to the adaptation. The model runs as it is given (the
    JAX export CLI runs it in f32 with BN unfolded)."""
    out_dir = Path(output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    device = next(model.parameters()).device
    if host_warp is None:
        host_warp = default_host_warp(device)
    np_rng = np.random.default_rng(seed)
    items = images.items() if hasattr(images, "items") else images
    paths = []
    for i, (name, img) in enumerate(items):
        img = np.ascontiguousarray(img, np.float32)
        if host_warp:
            homs = None if homographies is None else np.asarray(homographies[i])
            pts, scores, valid = homography_adaptation_host(model, img, np_rng, homs,
                                                            **ha_kwargs)
            arr = np.concatenate([pts[valid], scores[valid, None]], axis=1)
        else:
            x = torch.from_numpy(img).to(device)
            if homographies is None:
                kw = dict(gen=image_generator(seed, i, device))
            else:
                kw = dict(homographies=torch.as_tensor(np.asarray(homographies[i]),
                                                       device=device))
            pts, scores, valid = homography_adaptation_batch(model, x, **kw, **ha_kwargs)
            arr = torch.cat([pts[valid], scores[valid, None]], dim=1).cpu().numpy()
        if normalize_points:
            h, w = img.shape[:2]
            arr[:, 0] /= w
            arr[:, 1] /= h
        p = out_dir / f"{name}.npz"
        np.savez_compressed(p, pts=arr)
        paths.append(p)
    return paths
