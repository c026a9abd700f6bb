"""Batched photometric augmentation.

Counterpart of `yolopoint_tpu/data/photometric.py`: the configured menu
(brightness, contrast, Gaussian and speckle noise, elementwise and per-image
offsets, channel shuffle, motion blur, HSV scaling, Gaussian blur, additive
elliptic shade) applied to a whole `(B, H, W, C)` f32 batch in [0, 1],
with the parameter names of the YAML schema
(`data.augmentation.photometric.params`).

Randomness is split from the arithmetic: `draw_photometric` takes a
`torch.Generator` and returns every random sample the menu needs;
`photometric_augment` applies the menu to those samples. A test can then
feed both packages the same samples.
"""

from __future__ import annotations

import math
from typing import Any, Mapping

import torch
import torch.nn.functional as F


def _uniform(gen, shape, lo, hi):
    return torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) + lo


def _coin(gen, shape, p=0.5):
    return torch.rand(shape, generator=gen, device=gen.device) < p


def _range(p, default):
    val = p.get("value", default) if isinstance(p, Mapping) else p
    return tuple(val) if isinstance(val, (list, tuple)) else (-val, val)


def draw_photometric(gen: torch.Generator, shape, params: Mapping[str, Any]) -> dict:
    """Every random sample `photometric_augment` needs for a batch of
    `shape` `(B, H, W, C)` under `params`, drawn from `gen` on its device."""
    B, H, W, C = shape
    per_image = (B, 1, 1, 1)
    d: dict = {}
    if p := params.get("random_brightness"):
        change = p["max_abs_change"] / 255.0
        d["brightness"] = _uniform(gen, per_image, -change, change)
    if p := params.get("random_contrast"):
        d["contrast"] = _uniform(gen, per_image, *p["strength_range"])
    if p := params.get("additive_gaussian_noise"):
        lo, hi = p["stddev_range"]
        d["noise_std"] = _uniform(gen, per_image, lo / 255.0, hi / 255.0)
        d["noise"] = torch.randn(shape, generator=gen, device=gen.device)
    if p := params.get("additive_speckle_noise"):
        d["speckle_prob"] = _uniform(gen, per_image, *p["prob_range"])
        d["speckle_u"] = torch.rand((B, H, W, 1), generator=gen, device=gen.device)
        d["speckle_salt"] = _coin(gen, (B, H, W, 1))
    if p := params.get("add_elementwise"):
        lo, hi = _range(p, (-10, 10))
        d["add_elementwise"] = _uniform(gen, shape, lo / 255.0, hi / 255.0)
    if p := params.get("add"):
        lo, hi = _range(p, (-20, 20))
        d["add_do"] = _coin(gen, per_image)
        d["add"] = _uniform(gen, per_image, lo / 255.0, hi / 255.0)
    if p := params.get("channel_shuffle"):
        prob = float(p) if not isinstance(p, Mapping) else float(p.get("p", 0.5))
        d["shuffle_do"] = _coin(gen, (B,), prob)
        d["shuffle_perm"] = torch.rand((B, C), generator=gen, device=gen.device).argsort(dim=1)
    if params.get("motion_blur"):
        d["motion_do"] = _coin(gen, per_image)
        d["motion_horizontal"] = _coin(gen, ())
    if p := params.get("hsv"):
        h_amp, s_amp, v_amp = p
        d["hsv"] = [_uniform(gen, (B, 1, 1), 1 - a, 1 + a) for a in (h_amp, s_amp, v_amp)]
    if params.get("GaussianBlur"):
        d["blur_do"] = _coin(gen, per_image)
    if p := params.get("additive_shade"):
        n = int(p.get("nb_ellipses", 20)) if isinstance(p, Mapping) else 20
        lo, hi = p.get("transparency_range", (-0.5, 0.8)) if isinstance(p, Mapping) else (-0.5, 0.8)
        d["shade"] = {
            "axes": torch.rand((B, n, 2), generator=gen, device=gen.device),
            "centers": _uniform(gen, (B, n, 2), 0.15, 0.85),
            "angles": _uniform(gen, (B, n), 0.0, math.pi / 2),
            "transparency": _uniform(gen, per_image, lo, hi),
        }
    return d


def _separable(x: torch.Tensor, taps: torch.Tensor, dim: int) -> torch.Tensor:
    """Zero-padded 1-D correlation of NHWC `x` with `taps` along `dim` (1 = rows,
    2 = columns), as shifted multiply-adds in f32."""
    r = (taps.numel() - 1) // 2
    pad = [0, 0, 0, 0, 0, 0]  # F.pad order: C, then W, then H
    pad[2 * (3 - dim)] = pad[2 * (3 - dim) + 1] = r
    xp = F.pad(x, pad)
    n = x.shape[dim]
    out = None
    for t in range(taps.numel()):
        term = xp.narrow(dim, t, n) * taps[t]
        out = term if out is None else out + term
    return out


def gaussian_blur(images: torch.Tensor, sigma: float, truncate: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur of NHWC images (rows, then columns), zero
    padding, radius `max(1, int(truncate * sigma + 0.5))`."""
    if sigma <= 0:
        return images
    radius = max(1, int(truncate * sigma + 0.5))
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=images.device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = k / k.sum()
    return _separable(_separable(images, k, 1), k, 2)


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """RGB -> HSV, hue in [0, 1)."""
    r, g, b = rgb.unbind(-1)
    maxc, minc = rgb.amax(dim=-1), rgb.amin(dim=-1)
    diff = maxc - minc
    s = torch.where(maxc > 0, diff / maxc.clamp(min=1e-12), 0.0)
    safe = diff.clamp(min=1e-12)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(diff > 0, torch.remainder(h / 6.0, 1.0), 0.0)
    return torch.stack([h, s, maxc], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv.unbind(-1)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1.0 - s), v * (1.0 - s * f), v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.long(), 6)[..., None]
    pick = lambda *c: torch.gather(torch.stack(c, dim=-1), -1, i)[..., 0]  # noqa: E731
    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], dim=-1)


def additive_shade(images: torch.Tensor, shade: Mapping[str, torch.Tensor],
                   blur_sigma: float = 50.0) -> torch.Tensor:
    """Soft elliptic shadows: the ellipses of `shade` (from
    `draw_photometric`) evaluated on a quarter-resolution grid, blurred,
    bilinearly upsampled and multiplied in with a per-image transparency."""
    B, H, W, C = images.shape
    hs, ws = H // 4, W // 4
    min_dim = min(hs, ws) / 4
    ax = torch.maximum(shade["axes"] * min_dim, torch.tensor(min_dim / 5, device=images.device))
    centers = shade["centers"] * torch.tensor([ws, hs], dtype=torch.float32, device=images.device)
    ang = shade["angles"]
    xs = torch.arange(ws, dtype=torch.float32, device=images.device)[None, None, None, :]
    ys = torch.arange(hs, dtype=torch.float32, device=images.device)[None, None, :, None]
    dx = xs - centers[..., 0, None, None]
    dy = ys - centers[..., 1, None, None]
    ca, sa = torch.cos(ang)[..., None, None], torch.sin(ang)[..., None, None]
    u = dx * ca + dy * sa
    v = -dx * sa + dy * ca
    inside = (u / ax[..., 0, None, None]) ** 2 + (v / ax[..., 1, None, None]) ** 2 <= 1.0
    mask = inside.any(dim=1).to(torch.float32)[..., None]  # (B, hs, ws, 1)
    mask = gaussian_blur(mask, blur_sigma / 4.0)
    mask = F.interpolate(mask.permute(0, 3, 1, 2), size=(H, W), mode="bilinear",
                         align_corners=False).permute(0, 2, 3, 1)
    return (images * (1.0 - shade["transparency"] * mask)).clamp(0.0, 1.0)


def _masked_blur(blur_fn, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Normalized convolution: blur with in-support pixels only."""
    m = mask[..., None] if mask.dim() == 3 else mask
    num = blur_fn(x * m)
    den = blur_fn(torch.broadcast_to(m, x.shape))
    return torch.where(m > 0, num / den.clamp(min=1e-6), x)


def photometric_augment(
    images: torch.Tensor,
    params: Mapping[str, Any],
    draws: Mapping[str, Any],
    support_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Apply the configured menu to `(B, H, W, C)` images in [0, 1] with the
    samples of `draw_photometric`; the result is clipped to [0, 1].

    `support_mask` `(B, H, W)` restricts the blurs to in-support pixels
    (normalized convolution), for photometric work after a warp.
    """
    x = images
    if params.get("random_brightness"):
        x = x + draws["brightness"]
    if params.get("random_contrast"):
        x = (x - 0.5) * draws["contrast"] + 0.5
    if params.get("additive_gaussian_noise"):
        x = x + draws["noise"] * draws["noise_std"]
    if params.get("additive_speckle_noise"):
        speckle = torch.where(draws["speckle_salt"], 1.0, 0.0)
        x = torch.where(draws["speckle_u"] < draws["speckle_prob"], speckle, x)
    if params.get("add_elementwise"):
        x = x + draws["add_elementwise"]
    if params.get("add"):
        x = torch.where(draws["add_do"], x + draws["add"], x)
    if params.get("channel_shuffle"):
        perm = draws["shuffle_perm"][:, None, None, :].expand(x.shape)
        x = torch.where(draws["shuffle_do"][:, None, None, None], torch.gather(x, 3, perm), x)
    if p := params.get("motion_blur"):
        ksize = int(p["max_kernel_size"]) if isinstance(p, Mapping) else int(p)
        ksize = max(3, ksize | 1)
        line = torch.full((ksize,), 1.0 / ksize, device=x.device)
        mb_v = lambda t: _separable(t, line, 1)  # noqa: E731
        mb_h = lambda t: _separable(t, line, 2)  # noqa: E731
        if support_mask is not None:
            blur_v, blur_h = _masked_blur(mb_v, x, support_mask), _masked_blur(mb_h, x, support_mask)
        else:
            blur_v, blur_h = mb_v(x), mb_h(x)
        x = torch.where(draws["motion_do"], torch.where(draws["motion_horizontal"], blur_h, blur_v), x)
    if params.get("hsv"):
        hm, sm, vm = draws["hsv"]
        hsv = rgb_to_hsv(x.clamp(0.0, 1.0))
        hsv = torch.stack([torch.remainder(hsv[..., 0] * hm, 1.0), (hsv[..., 1] * sm).clamp(0, 1),
                           (hsv[..., 2] * vm).clamp(0, 1)], dim=-1)
        x = hsv_to_rgb(hsv)
    if p := params.get("GaussianBlur"):
        sigma = float(p["sigma"] if isinstance(p, Mapping) else p)
        gb = lambda t: gaussian_blur(t, sigma)  # noqa: E731
        blurred = _masked_blur(gb, x, support_mask) if support_mask is not None else gb(x)
        x = torch.where(draws["blur_do"], blurred, x)
    if p := params.get("additive_shade"):
        sigma = float(p.get("blur_sigma", 50.0)) if isinstance(p, Mapping) else 50.0
        x = additive_shade(x, draws["shade"], sigma)
    return x.clamp(0.0, 1.0)
