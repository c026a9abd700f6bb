"""Homographic augmentation and warped-pair generation on the device.

Counterpart of `yolopoint_tpu/data/augmentation.py`: from a raw batch, the
(base, warped) training pair. The base view is the photometrically
augmented image warped by a random homography H1; the warped view warps
the lightly augmented image once by H1 @ H2 and stores H2, which links the
two views. Points are warped and re-rasterized, boxes warped corner-wise
and filtered with `box_candidates`; dropped points and boxes only lose
their mask bit, so every shape is fixed. Crop-aware training warps the
full frame by the crop-conjugated homography and crops the result.

Mosaic batches (a 2x2 canvas of four samples, `(2H, 2W)`) are trained
through the same crop chain, on the canvas's centre `(H, W)` crop, with the
mosaic's own homography parameters and the canvas's tile-border mask
(`mosaic_canvas_mask`) warped as the source's validity.

Randomness is split from the arithmetic: `draw_training_views` draws the
flips, the photometric samples and H1, H2 from a `torch.Generator`;
`build_training_views` applies them. The two image warps of every step
(and, in crop and mosaic mode, the nearest warps of the masks) go through
`ops.geometry.warp_image`, the CUDA warp on the card.

The host-warp path (`data.host_augment`) hands `build_training_views` the
views, their masks and H1, H2 already made (`precomputed`): no image warp
runs here, and the photometric passes run after the warp, restricted to
each view's analytic coverage (`coverage_mask`); `draw_training_views`
then draws only the photometric samples.
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
    mat3_inverse,
    mat3_product,
    points_to_label_map,
    warp_image,
    warp_points,
    warped_pair_valid_mask,
)
from yolopoint_tpu_torch.ops.homography import sample_homography_batch


# a host-warped batch's payload (`precomputed_<name>` in the batch)
PRECOMPUTED_KEYS = ("image_base", "valid_base", "image_pair", "valid_pair", "h1", "h2")


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
    # `C` in f64, rounded once to f32: the card divides by a number as a
    # multiplication by its reciprocal, an f32 ulp off the CPU's quotient
    y0 = crop_yx[..., 0].to(torch.float64)
    x0 = crop_yx[..., 1].to(torch.float64)
    zeros, ones = torch.zeros_like(x0), torch.ones_like(x0)
    C = torch.stack([
        torch.stack([torch.full_like(x0, wc / Wf), zeros, (2.0 * x0 + wc) / Wf - 1.0], -1),
        torch.stack([zeros, torch.full_like(x0, hc / Hf), (2.0 * y0 + hc) / Hf - 1.0], -1),
        torch.stack([zeros, zeros, ones], -1),
    ], dim=-2).to(torch.float32)
    return mat3_product(C, homography, mat3_inverse(C))


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
    valid_src: Optional[torch.Tensor] = None,
    warped_image: Optional[torch.Tensor] = None,
    warped_valid: Optional[torch.Tensor] = None,
) -> AugmentedView:
    """One warped view from `(B, 3, 3)` crop-frame normalized homographies.

    `images` `(B, H, W, C)` (the full frame in crop mode), `points`
    `(B, N, 2)` full-frame pixels, `boxes` `(B, M, 5)` normalized to the full
    frame. The valid mask is the analytic one (`compute_valid_mask`), or,
    given a full-frame `valid_src` `(B, H, W)`, that mask's nearest warp
    with the view's one-pixel rim zeroed; `with_valid_mask=False` skips it
    (returned as `None`) where the caller replaces it. `warped_image` and
    `warped_valid`, in the view's frame, are the view and its mask made
    elsewhere (the host-warp path): no warp runs, and only `images`' shape
    is read.
    """
    B, Hf, Wf, _ = images.shape
    inv_homography = mat3_inverse(homography)
    valid_mask = warped_valid
    precomputed = warped_image is not None
    if warped_valid is not None:
        with_valid_mask = False
    if crop_yx is not None:
        if crop_hw is None:
            raise ValueError("crop_hw must be given with crop_yx")
        Hc, Wc = crop_hw
        if not precomputed or with_valid_mask:
            hom_big = crop_conjugate_homography(homography, crop_yx, crop_hw, (Hf, Wf))
        if not precomputed:
            warped_image = _crop_images(warp_image(images, hom_big), crop_yx, crop_hw)
        if with_valid_mask and valid_src is not None:
            vm = warp_image(valid_src[..., None].contiguous(), hom_big, mode="nearest")
            valid_mask = _zero_rim(_crop_images(vm, crop_yx, crop_hw)[..., 0])
        elif with_valid_mask:
            vm = compute_valid_mask((Hf, Wf), hom_big, valid_border_margin, pad)
            valid_mask = _crop_images(vm[..., None], crop_yx, crop_hw)[..., 0]
        offset = crop_yx[:, None].flip(-1).to(torch.float32)  # (B, 1, 2) (x, y)
        pts = torch.floor(points) - offset
        box_xyxy = xywhn2xyxy(boxes[..., 1:5], Wf, Hf) - torch.cat([offset, offset], dim=-1)
    else:
        Hc, Wc = Hf, Wf
        if not precomputed:
            warped_image = warp_image(images, homography)
        if with_valid_mask and valid_src is not None:
            vm = warp_image(valid_src[..., None].contiguous(), homography, mode="nearest")
            valid_mask = _zero_rim(vm[..., 0])
        elif with_valid_mask:
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


def _zero_rim(mask: torch.Tensor) -> torch.Tensor:
    """`(B, H, W)` mask with its first and last rows and columns zeroed."""
    mask = mask.clone()
    mask[:, :1] = 0
    mask[:, -1:] = 0
    mask[:, :, :1] = 0
    mask[:, :, -1:] = 0
    return mask


def mosaic_canvas_mask(full_hw: tuple[int, int], border: int = 2,
                       device: torch.device | str = "cpu") -> torch.Tensor:
    """Validity of a 2x2 equal-tile mosaic canvas: zero `border` pixels
    around each tile (the reference zeroes the tiles' borders)."""
    Hf, Wf = full_hw
    m = torch.ones((Hf, Wf), device=device)
    for y in (0, Hf // 2, Hf):
        m[max(y - border, 0):min(y + border, Hf)] = 0.0
    for x in (0, Wf // 2, Wf):
        m[:, max(x - border, 0):min(x + border, Wf)] = 0.0
    return m


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


def _homography_params(hom: Mapping, pair: Mapping, mosaic: bool) -> tuple[dict, dict]:
    """H1's and H2's sampler parameters: `homographic.params` and
    `warped_pair.params`, replaced for a mosaic by `homographic.mosaic.params`
    and `warped_pair.mosaic_params` where given."""
    h1 = hom.get("params") or {}
    if mosaic and (m := hom.get("mosaic")):
        h1 = m.get("params") or h1
    h2 = pair.get("params") or h1
    if mosaic and (m := pair.get("mosaic_params")):
        h2 = m
    return h1, h2


def view_hw(full_hw: tuple[int, int], config: Mapping[str, Any], crop: bool = False,
            mosaic: bool = False) -> tuple[int, int]:
    """The `(H, W)` of the views of a batch whose images are `full_hw`: the
    mosaic canvas's centre half, `homographic.cropHW` in crop mode, else the
    frame."""
    Hf, Wf = full_hw
    if not crop:
        return Hf, Wf
    if mosaic:
        return Hf // 2, Wf // 2
    return tuple((config.get("homographic") or {}).get("cropHW") or (Hf, Wf))


def draw_training_views(gen: torch.Generator, shape, config: Mapping[str, Any],
                        crop: bool = False, mosaic: bool = False,
                        precomputed: bool = False) -> dict:
    """Every random sample `build_training_views` needs for a batch of
    `shape` `(B, H, W, C)` under the `data.augmentation` config: flips,
    the three photometric passes' samples and the homographies `h1`, `h2`.
    `crop` (the batch has a crop corner) and `mosaic` set the view's size,
    which the warped view's photometric pass draws at, and the homography
    parameters; a mosaic always draws H1. For a `precomputed` (host-warp)
    batch only the photometric samples are drawn, all three at the view's
    size."""
    B, C = shape[0], shape[3]
    view_shape = (B, *view_hw(tuple(shape[1:3]), config, crop, mosaic), C)
    phot, hom, pair = _sections(config)
    draws: dict = {}
    if precomputed:
        if phot.get("enable", False):
            params = phot.get("params") or {}
            if phot.get("params_light") is not None:
                draws["phot_light"] = draw_photometric(gen, view_shape, phot["params_light"] or {})
            draws["phot_base"] = draw_photometric(gen, view_shape, params)
            pair_params = (pair.get("photometric") or {}).get("params") or params
            draws["phot_pair"] = draw_photometric(gen, view_shape, pair_params)
        return draws
    if flipping := hom.get("flipping"):
        draws["flip"] = draw_flips(gen, B, float(flipping.get("horizontal", 0.0)),
                                   float(flipping.get("vertical", 0.0)))
    if phot.get("enable", False):
        params = phot.get("params") or {}
        if phot.get("params_light") is not None:
            draws["phot_light"] = draw_photometric(gen, shape, phot["params_light"] or {})
        draws["phot_base"] = draw_photometric(gen, shape, params)
        pair_params = (pair.get("photometric") or {}).get("params") or params
        draws["phot_pair"] = draw_photometric(gen, view_shape, pair_params)
    h1_params, h2_params = _homography_params(hom, pair, mosaic)
    if hom.get("enable", False) or mosaic:
        draws["h1"] = sample_homography_batch(gen, B, **h1_params)
    draws["h2"] = sample_homography_batch(gen, B, **h2_params)
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
    is the `data.augmentation` subtree; u8 images are scaled to [0, 1]. A
    `mosaic` batch (a `(2H, 2W)` canvas, `crop_yx` its centre crop's corner)
    warps by H1 whatever `homographic.enable` says, views the `(H, W)`
    crop, and takes its valid masks from the canvas's tile-border mask.

    `precomputed` (the host-warp path, `data.host_augment`) maps
    `image_base`, `valid_base`, `image_pair`, `valid_pair` (the views and
    their masks, u8 or f32, in the view's frame) and `h1`, `h2` (any flip
    composed into `h1`); `images` is then read for its shape only and
    `draws` comes from `draw_training_views(..., precomputed=True)`.
    """
    if precomputed is not None:
        return _views_from_precomputed(images, points, point_mask, boxes, box_mask, config,
                                       precomputed, draws, crop_yx=crop_yx, mosaic=mosaic)
    B, Hf, Wf, _ = images.shape
    if images.dtype == torch.uint8:
        images = images.to(torch.float32) / 255.0
    phot, hom, pair = _sections(config)
    margin = int(hom.get("valid_border_margin", 0))
    hom_enabled = bool(hom.get("enable", False))
    crop_hw = None
    if crop_yx is not None:
        crop_hw = view_hw((Hf, Wf), config, crop=True, mosaic=mosaic)

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

    valid_src = None
    if mosaic:
        valid_src = mosaic_canvas_mask((Hf, Wf), device=images.device).expand(B, Hf, Wf)
    if hom_enabled or mosaic:
        h1 = draws["h1"]
        base = homographic_augment(base_img, points, point_mask, boxes, box_mask, h1,
                                   valid_border_margin=margin, crop_yx=crop_yx, crop_hw=crop_hw,
                                   valid_src=valid_src)
    else:
        h1 = torch.eye(3, device=images.device).expand(B, 3, 3)
        base = _identity_view(base_img, points, point_mask, boxes, box_mask, crop_yx, crop_hw)

    h2 = draws["h2"]
    warped = homographic_augment(
        pair_img, points, point_mask, boxes, box_mask, mat3_product(h1, h2),
        valid_border_margin=int(pair.get("valid_border_margin", margin)),
        crop_yx=crop_yx, crop_hw=crop_hw, with_valid_mask=False)
    if crop_yx is None and valid_src is None:
        pair_mask = warped_pair_valid_mask(base.valid_mask.shape[1:3], h1, h2,
                                           erosion_radius=margin if hom_enabled else 0)
    else:
        pair_mask = warp_image(base.valid_mask[..., None].contiguous(), h2, mode="nearest")[..., 0]
    warped = warped._replace(valid_mask=pair_mask, homography=h2,
                             inv_homography=mat3_inverse(h2))
    if phot.get("enable", False):
        pair_params = (pair.get("photometric") or {}).get("params") or phot.get("params") or {}
        warped = warped._replace(image=photometric_augment(warped.image, pair_params,
                                                           draws["phot_pair"]))
    return base, warped


def coverage_mask(out_hw: tuple[int, int], homography: torch.Tensor,
                  crop_yx: Optional[torch.Tensor], full_hw: tuple[int, int]) -> torch.Tensor:
    """`(B, h, w)`: 1 where an output pixel (of the crop at `crop_yx`, or of
    the frame) maps by `homography` `(B, 3, 3)` (full-frame normalized) into
    the source frame, to 1e-6. Each operation is its own rounded step and
    no division is by a Python number (the card would multiply by the
    reciprocal), so the card and the CPU give the same mask."""
    Hc, Wc = out_hw
    Hf, Wf = full_hw
    dev = homography.device
    B = homography.shape[0]
    xs = torch.arange(Wc, dtype=torch.float32, device=dev)[None, None, :].expand(B, Hc, Wc)
    ys = torch.arange(Hc, dtype=torch.float32, device=dev)[None, :, None].expand(B, Hc, Wc)
    if crop_yx is not None:
        xs = xs + crop_yx[:, 1].to(torch.float32)[:, None, None]
        ys = ys + crop_yx[:, 0].to(torch.float32)[:, None, None]
    xn = (xs * 2.0) / torch.tensor(float(max(Wf - 1, 1)), device=dev) - 1.0
    yn = (ys * 2.0) / torch.tensor(float(max(Hf - 1, 1)), device=dev) - 1.0
    h = homography.reshape(B, 3, 3).to(torch.float32)

    def row(i):
        return h[:, i, 0, None, None] * xn + h[:, i, 1, None, None] * yn + h[:, i, 2, None, None]

    d = row(2)
    sx, sy = row(0) / d, row(1) / d
    eps = 1e-6
    return ((sx.abs() <= 1.0 + eps) & (sy.abs() <= 1.0 + eps)).to(torch.float32)


def _as_float(img: torch.Tensor) -> torch.Tensor:
    return img.to(torch.float32) / 255.0 if img.dtype == torch.uint8 else img.to(torch.float32)


def _views_from_precomputed(images, points, point_mask, boxes, box_mask, config, pre, draws,
                            crop_yx=None, mosaic: bool = False) -> tuple[AugmentedView, AugmentedView]:
    """The (base, warped) pair of a host-warped batch: labels, points and
    boxes from `h1` and `h1 @ h2`, the views and masks as given, then the
    photometric passes under each view's coverage (the light pass's samples
    shared by both views, as the reference applies one light pass before
    the warp), each view zeroed outside its coverage."""
    if missing := [k for k in PRECOMPUTED_KEYS if k not in pre]:
        raise KeyError(f"the precomputed views lack {missing}")
    B, Hf, Wf, _ = images.shape
    phot, hom, pair = _sections(config)
    crop_hw = None
    if crop_yx is not None:
        crop_hw = view_hw((Hf, Wf), config, crop=True, mosaic=mosaic)
    h1 = pre["h1"].to(torch.float32)
    h2 = pre["h2"].to(torch.float32)
    h12 = mat3_product(h1, h2)
    base = homographic_augment(images, points, point_mask, boxes, box_mask, h1,
                               crop_yx=crop_yx, crop_hw=crop_hw,
                               warped_image=_as_float(pre["image_base"]),
                               warped_valid=pre["valid_base"].to(torch.float32))
    warped = homographic_augment(images, points, point_mask, boxes, box_mask, h12,
                                 crop_yx=crop_yx, crop_hw=crop_hw,
                                 warped_image=_as_float(pre["image_pair"]),
                                 warped_valid=pre["valid_pair"].to(torch.float32))
    warped = warped._replace(homography=h2, inv_homography=mat3_inverse(h2))
    if not phot.get("enable", False):
        return base, warped

    out_hw = crop_hw or (Hf, Wf)
    if crop_yx is not None:
        cov_b = coverage_mask(out_hw, crop_conjugate_homography(h1, crop_yx, crop_hw, (Hf, Wf)),
                              crop_yx, (Hf, Wf))
        cov_p = coverage_mask(out_hw, crop_conjugate_homography(h12, crop_yx, crop_hw, (Hf, Wf)),
                              crop_yx, (Hf, Wf))
    else:
        cov_b = coverage_mask(out_hw, h1, None, (Hf, Wf))
        cov_p = coverage_mask(out_hw, h12, None, (Hf, Wf))
    b_img, p_img = base.image, warped.image
    light = phot.get("params_light")
    if light is not None:
        b_img = photometric_augment(b_img, light or {}, draws["phot_light"], cov_b)
        p_img = photometric_augment(p_img, light or {}, draws["phot_light"], cov_p)
    params = phot.get("params") or {}
    pair_params = (pair.get("photometric") or {}).get("params") or params
    b_img = photometric_augment(b_img, params, draws["phot_base"], cov_b) * cov_b[..., None]
    p_img = photometric_augment(p_img, pair_params, draws["phot_pair"], cov_p) * cov_p[..., None]
    return base._replace(image=b_img), warped._replace(image=p_img)
