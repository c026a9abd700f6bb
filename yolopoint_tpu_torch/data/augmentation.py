"""Homographic augmentation and warped-pair generation on the device.

Counterpart of `yolopoint_tpu/data/augmentation.py`: from a raw batch, the
(base, warped) training pair. The base view is the photometrically
augmented image warped by a random homography H1; the warped view warps
the lightly augmented image once by H1 @ H2 and stores H2, which links the
two views. Points are warped and re-rasterized, boxes warped corner-wise
and filtered with `box_candidates`; dropped points and boxes only lose
their mask bit, so every shape is fixed. Crop-aware training warps the
full frame by the crop-conjugated homography and crops the result.

Randomness is split from the arithmetic: `draw_training_views` draws the
flips, the photometric samples and H1, H2 from a `torch.Generator`;
`build_training_views` applies them. The two image warps of every step
(and, in crop mode, the pair mask's nearest warp) go through
`ops.geometry.warp_image`, the CUDA warp on the card.

Not ported yet (they raise `NotImplementedError`): the host-warp
`precomputed` path and the mosaic path.
"""

from __future__ import annotations

from typing import Any, Mapping, NamedTuple, Optional

import torch

from yolopoint_tpu_torch.data.photometric import draw_photometric, photometric_augment
from yolopoint_tpu_torch.ops.boxes import clip_boxes, xywhn2xyxy, xyxy2xywhn
from yolopoint_tpu_torch.ops.geometry import (
    compute_valid_mask,
    filter_points_mask,
    homography_scaling,
    points_to_label_map,
    warp_image,
    warp_points,
    warped_pair_valid_mask,
)
from yolopoint_tpu_torch.ops.homography import sample_homography_batch


class AugmentedView(NamedTuple):
    """One homographically augmented view of a batch."""

    image: torch.Tensor           # (B, H, W, C)
    labels_2d: torch.Tensor       # (B, H, W) keypoint map
    valid_mask: torch.Tensor      # (B, H, W)
    points: torch.Tensor          # (B, N, 2) warped keypoints
    point_mask: torch.Tensor      # (B, N)
    boxes: torch.Tensor           # (B, M, 5) [cls, cx, cy, w, h] normalized
    box_mask: torch.Tensor        # (B, M)
    homography: torch.Tensor      # (B, 3, 3) normalized coords
    inv_homography: torch.Tensor  # (B, 3, 3)


def box_candidates_mask(new_xyxy, old_xyxy, wh_thr: float = 7.0, area_thr: float = 25.0,
                        wr_thresh: float = 0.2, hr_thresh: float = 0.2) -> torch.Tensor:
    """Mask form of YOLOv5's `box_candidates`: big enough, not squashed."""
    w1 = new_xyxy[..., 2] - new_xyxy[..., 0]
    h1 = new_xyxy[..., 3] - new_xyxy[..., 1]
    w2 = (old_xyxy[..., 2] - old_xyxy[..., 0]).clamp(min=1e-9)
    h2 = (old_xyxy[..., 3] - old_xyxy[..., 1]).clamp(min=1e-9)
    return ((w1 > wh_thr) & (h1 > wh_thr) & (w1 * h1 > area_thr)
            & (w1 / w2 > wr_thresh) & (h1 / h2 > hr_thresh))


def crop_conjugate_homography(homography, crop_yx, crop_hw, full_hw) -> torch.Tensor:
    """`C @ H @ C^-1`: a crop-frame normalized homography in full-frame
    normalized coords, `C` mapping the crop's [-1, 1]^2 onto its rectangle."""
    hc, wc = crop_hw
    Hf, Wf = full_hw
    y0 = crop_yx[..., 0].to(torch.float32)
    x0 = crop_yx[..., 1].to(torch.float32)
    zeros, ones = torch.zeros_like(x0), torch.ones_like(x0)
    C = torch.stack([
        torch.stack([torch.full_like(x0, wc / Wf), zeros, (2.0 * x0 + wc) / Wf - 1.0], -1),
        torch.stack([zeros, torch.full_like(x0, hc / Hf), (2.0 * y0 + hc) / Hf - 1.0], -1),
        torch.stack([zeros, zeros, ones], -1),
    ], dim=-2)
    return C @ homography @ torch.linalg.inv(C)


def _crop_images(images: torch.Tensor, crop_yx: torch.Tensor, crop_hw) -> torch.Tensor:
    """Per-sample `(hc, wc)` crops at `crop_yx` `(B, 2)` (y, x), clamped into
    the frame as `lax.dynamic_slice` clamps."""
    hc, wc = crop_hw
    B, H, W = images.shape[:3]
    y0 = crop_yx[:, 0].long().clamp(0, H - hc)
    x0 = crop_yx[:, 1].long().clamp(0, W - wc)
    rows = (y0[:, None] + torch.arange(hc, device=images.device))[:, :, None]
    cols = (x0[:, None] + torch.arange(wc, device=images.device))[:, None, :]
    return images[torch.arange(B, device=images.device)[:, None, None], rows, cols]


def _warp_boxes_pix(xyxy, box_mask, inv_h_pix, height: int, width: int):
    """Warp pixel xyxy boxes corner-wise by the pixel-space inverse
    homography, re-order the corners, clip and filter."""
    tl_w = warp_points(xyxy[..., 0:2], inv_h_pix)
    br_w = warp_points(xyxy[..., 2:4], inv_h_pix)
    new_xyxy = torch.cat([torch.minimum(tl_w, br_w), torch.maximum(tl_w, br_w)], dim=-1)
    clipped = clip_boxes(new_xyxy, (height, width))
    return clipped, box_candidates_mask(clipped, new_xyxy) & box_mask


def draw_flips(gen: torch.Generator, batch: int, horizontal: float = 0.0,
               vertical: float = 0.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-image flip decisions `(do_h, do_v)`, each `(B,)` bool."""
    dev = gen.device
    do_h = (torch.rand(batch, generator=gen, device=dev) < horizontal) if horizontal \
        else torch.zeros(batch, dtype=torch.bool, device=dev)
    do_v = (torch.rand(batch, generator=gen, device=dev) < vertical) if vertical \
        else torch.zeros(batch, dtype=torch.bool, device=dev)
    return do_h, do_v


def flip_augment(images, points, boxes, do_h, do_v, crop_yx=None, crop_hw=None):
    """Flip image, points and normalized boxes per image (`do_h`, `do_v`
    from `draw_flips`); in crop mode the crop offsets mirror with the frame."""
    B, H, W, _ = images.shape
    img = torch.where(do_h[:, None, None, None], images.flip(2), images)
    img = torch.where(do_v[:, None, None, None], img.flip(1), img)
    px = torch.where(do_h[:, None], (W - 1) - points[..., 0], points[..., 0])
    py = torch.where(do_v[:, None], (H - 1) - points[..., 1], points[..., 1])
    bx = torch.where(do_h[:, None], 1.0 - boxes[..., 1], boxes[..., 1])
    by = torch.where(do_v[:, None], 1.0 - boxes[..., 2], boxes[..., 2])
    new_boxes = torch.cat([boxes[..., 0:1], bx[..., None], by[..., None], boxes[..., 3:5]], dim=-1)
    new_crop = crop_yx
    if crop_yx is not None and crop_hw is not None:
        hc, wc = crop_hw
        cy = torch.where(do_v, H - crop_yx[..., 0] - hc, crop_yx[..., 0])
        cx = torch.where(do_h, W - crop_yx[..., 1] - wc, crop_yx[..., 1])
        new_crop = torch.stack([cy, cx], dim=-1)
    return img, torch.stack([px, py], dim=-1), new_boxes, new_crop


def homographic_augment(
    images: torch.Tensor,
    points: torch.Tensor,
    point_mask: torch.Tensor,
    boxes: torch.Tensor,
    box_mask: torch.Tensor,
    homography: torch.Tensor,
    valid_border_margin: int = 0,
    pad: tuple[int, int, int, int] = (0, 0, 0, 0),
    crop_yx: Optional[torch.Tensor] = None,
    crop_hw: Optional[tuple[int, int]] = None,
    with_valid_mask: bool = True,
) -> AugmentedView:
    """One warped view from `(B, 3, 3)` crop-frame normalized homographies.

    `images` `(B, H, W, C)` (the full frame in crop mode), `points`
    `(B, N, 2)` full-frame pixels, `boxes` `(B, M, 5)` normalized to the full
    frame. The valid mask is the analytic one (`compute_valid_mask`);
    `with_valid_mask=False` skips it (returned as `None`) where the caller
    replaces it.
    """
    B, Hf, Wf, _ = images.shape
    inv_homography = torch.linalg.inv(homography)
    valid_mask = None
    if crop_yx is not None:
        if crop_hw is None:
            raise ValueError("crop_hw must be given with crop_yx")
        Hc, Wc = crop_hw
        hom_big = crop_conjugate_homography(homography, crop_yx, crop_hw, (Hf, Wf))
        warped_image = _crop_images(warp_image(images, hom_big), crop_yx, crop_hw)
        if with_valid_mask:
            vm = compute_valid_mask((Hf, Wf), hom_big, valid_border_margin, pad)
            valid_mask = _crop_images(vm[..., None], crop_yx, crop_hw)[..., 0]
        offset = crop_yx[:, None].flip(-1).to(torch.float32)  # (B, 1, 2) (x, y)
        pts = torch.floor(points) - offset
        box_xyxy = xywhn2xyxy(boxes[..., 1:5], Wf, Hf) - torch.cat([offset, offset], dim=-1)
    else:
        Hc, Wc = Hf, Wf
        warped_image = warp_image(images, homography)
        if with_valid_mask:
            valid_mask = compute_valid_mask((Hf, Wf), homography, valid_border_margin, pad)
        pts = torch.floor(points)
        box_xyxy = xywhn2xyxy(boxes[..., 1:5], Wf, Hf)

    # points warp by the INVERSE homography in (crop-frame) pixel coords
    inv_pix = homography_scaling(inv_homography, Hc, Wc)
    warped_pts = warp_points(pts, inv_pix)
    pmask = point_mask & filter_points_mask(warped_pts, (Wc, Hc))
    labels_2d = points_to_label_map(warped_pts, pmask, Hc, Wc)
    new_xyxy, new_box_mask = _warp_boxes_pix(box_xyxy, box_mask, inv_pix, Hc, Wc)
    new_boxes = torch.cat([boxes[..., 0:1], xyxy2xywhn(new_xyxy, Wc, Hc)], dim=-1)
    return AugmentedView(warped_image, labels_2d, valid_mask, warped_pts, pmask,
                         new_boxes, new_box_mask, homography, inv_homography)


def _identity_view(images, points, point_mask, boxes, box_mask, crop_yx, crop_hw) -> AugmentedView:
    """The un-warped view (identity homography), crop mode honoured."""
    B, Hf, Wf, _ = images.shape
    eye = torch.eye(3, device=images.device).expand(B, 3, 3).contiguous()
    if crop_yx is not None:
        return homographic_augment(images, points, point_mask, boxes, box_mask, eye,
                                   crop_yx=crop_yx, crop_hw=crop_hw)
    labels_2d = points_to_label_map(torch.floor(points), point_mask, Hf, Wf)
    ones = torch.zeros((B, Hf, Wf), device=images.device)
    ones[:, 1:-1, 1:-1] = 1.0
    pmask = point_mask & filter_points_mask(points, (Wf, Hf))
    return AugmentedView(images, labels_2d, ones, points, pmask, boxes, box_mask, eye, eye)


def _sections(config: Mapping[str, Any]):
    phot = config.get("photometric") or {}
    hom = config.get("homographic") or {}
    pair = config.get("warped_pair") or {}
    return phot, hom, pair


def draw_training_views(gen: torch.Generator, shape, config: Mapping[str, Any]) -> dict:
    """Every random sample `build_training_views` needs for a batch of
    `shape` `(B, H, W, C)` under the `data.augmentation` config: flips,
    the three photometric passes' samples and the homographies `h1`, `h2`."""
    B = shape[0]
    phot, hom, pair = _sections(config)
    draws: dict = {}
    if flipping := hom.get("flipping"):
        draws["flip"] = draw_flips(gen, B, float(flipping.get("horizontal", 0.0)),
                                   float(flipping.get("vertical", 0.0)))
    if phot.get("enable", False):
        params = phot.get("params") or {}
        if phot.get("params_light") is not None:
            draws["phot_light"] = draw_photometric(gen, shape, phot["params_light"] or {})
        draws["phot_base"] = draw_photometric(gen, shape, params)
        pair_params = (pair.get("photometric") or {}).get("params") or params
        draws["phot_pair"] = draw_photometric(gen, shape, pair_params)
    hom_params = hom.get("params") or {}
    if hom.get("enable", False):
        draws["h1"] = sample_homography_batch(gen, B, **hom_params)
    draws["h2"] = sample_homography_batch(gen, B, **(pair.get("params") or hom_params))
    return draws


def build_training_views(
    images: torch.Tensor,
    points: torch.Tensor,
    point_mask: torch.Tensor,
    boxes: torch.Tensor,
    box_mask: torch.Tensor,
    config: Mapping[str, Any],
    draws: Mapping[str, Any],
    crop_yx: Optional[torch.Tensor] = None,
    mosaic: bool = False,
    precomputed: Optional[Mapping[str, torch.Tensor]] = None,
) -> tuple[AugmentedView, AugmentedView]:
    """The (base, warped) training pair of a raw batch, from the samples of
    `draw_training_views`.

    The pair base gets the light photometric pass, the base view light +
    full; the base view is warped by H1; the warped view warps the lightly
    augmented image once by H1 @ H2, takes as valid mask the base mask
    warped by H2 (closed form) and gets its own photometric pass. `config`
    is the `data.augmentation` subtree; u8 images are scaled to [0, 1].
    """
    if precomputed is not None:
        raise NotImplementedError("the host-warp (precomputed) path is not ported yet")
    if mosaic:
        raise NotImplementedError("the mosaic path is not ported yet")
    B, Hf, Wf, _ = images.shape
    if images.dtype == torch.uint8:
        images = images.to(torch.float32) / 255.0
    phot, hom, pair = _sections(config)
    margin = int(hom.get("valid_border_margin", 0))
    hom_enabled = bool(hom.get("enable", False))
    crop_hw = None
    if crop_yx is not None:
        crop_hw = tuple(hom.get("cropHW") or (Hf, Wf))

    if "flip" in draws:
        images, points, boxes, crop_yx = flip_augment(images, points, boxes, *draws["flip"],
                                                      crop_yx=crop_yx, crop_hw=crop_hw)

    if phot.get("enable", False):
        light = phot.get("params_light")
        pair_img = photometric_augment(images, light or {}, draws["phot_light"]) \
            if light is not None else images
        base_img = photometric_augment(pair_img, phot.get("params") or {}, draws["phot_base"])
    else:
        pair_img = base_img = images

    if hom_enabled:
        h1 = draws["h1"]
        base = homographic_augment(base_img, points, point_mask, boxes, box_mask, h1,
                                   valid_border_margin=margin, crop_yx=crop_yx, crop_hw=crop_hw)
    else:
        h1 = torch.eye(3, device=images.device).expand(B, 3, 3)
        base = _identity_view(base_img, points, point_mask, boxes, box_mask, crop_yx, crop_hw)

    h2 = draws["h2"]
    warped = homographic_augment(
        pair_img, points, point_mask, boxes, box_mask, h1 @ h2,
        valid_border_margin=int(pair.get("valid_border_margin", margin)),
        crop_yx=crop_yx, crop_hw=crop_hw, with_valid_mask=False)
    if crop_yx is None:
        pair_mask = warped_pair_valid_mask(base.valid_mask.shape[1:3], h1, h2,
                                           erosion_radius=margin if hom_enabled else 0)
    else:
        pair_mask = warp_image(base.valid_mask[..., None].contiguous(), h2, mode="nearest")[..., 0]
    warped = warped._replace(valid_mask=pair_mask, homography=h2,
                             inv_homography=torch.linalg.inv(h2))
    if phot.get("enable", False):
        pair_params = (pair.get("photometric") or {}).get("params") or phot.get("params") or {}
        warped = warped._replace(image=photometric_augment(warped.image, pair_params,
                                                           draws["phot_pair"]))
    return base, warped
