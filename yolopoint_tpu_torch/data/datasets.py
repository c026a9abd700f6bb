"""Host-side image reading, the image-file datasets, the dataset factory and
the HPatches sequences, without OpenCV.

Counterpart of `yolopoint_tpu/data/datasets.py`. `_imread` returns what
`cv2.imread(path, cv2.IMREAD_COLOR)` returns, uint8 `(H, W, 3)` in BGR
order, or what `IMREAD_GRAYSCALE` returns (with a channel axis) where the
config's `input_channels` is 1, for JPEG files (`data/jpeg.py`: sequential
of one or more scans and progressive, Huffman or arithmetic coded, and
lossless: one component in grey reads, RGB in colour reads, CMYK in both;
with the EXIF orientation applied), PNG files (`data/png.py`, Adam7 too),
BMP files (`data/bmp.py`: 1 to 32 bits, run-length coded too), PBM / PGM /
PPM files (`data/netpbm.py`: `P1` to `P6` at any maxval; HPatches-layout
sequences are `P6`), TIFF files (`data/tiff.py`: libtiff's RGBA interface,
as OpenCV reads them), GIF files (`data/gif.py`: the first frame), Sun
raster files (`data/sunras.py`), PAM files (`data/pam.py`), PFM files
(`data/pfm.py`) and Radiance HDR files (`data/radiance.py`). It tells them
apart by their first bytes, as `cv2.imread` picks its decoder. Where
`cv2.imread` returns None (a reader raises `errors.Unreadable`) it raises
`FileNotFoundError`, as the JAX package's `_imread` does; where
`cv2.imread` reads a file that the port does not (a format of
`UNPORTED_SIGNATURES`, or a TIFF layout `data/tiff.py` does not read),
`NotImplementedError` naming the file and the format. Any other exception
of a reader is its own fault and propagates.

The image-file datasets (`Coco`, `Kitti`, `Campus` and the generic
`ImagePointBoxDataset`) read the reference's layout:

  <root>/<name>/images[size]/<split>/*.png|jpg
  <root>/<name>/labels[size]/<split>/*.txt    (YOLO boxes: cls cx cy w h)
  <points_dir>/<split>/*.npz                  ({'pts': (N, 2 or 3)})

and decode, resize (`data/native.py`: the JAX package's native resize, bit
for bit), letterbox or crop, and compose mosaics exactly as the JAX
datasets do. Where those draw from the global `np.random`, these take an
explicit `np.random.RandomState` (`get(idx, mosaic, rng)`) and make the
same calls in the same order. A dataset feeding the CPU (`device="cpu"`)
decodes and resizes in numpy; any other device in compiled host code
(`ops/csrc/host_image.cpp`), which is built when the dataset is made, or
it raises. `HPatches` resizes with `ops.resize` (OpenCV's `INTER_LINEAR` /
`INTER_AREA` in torch).
"""

from __future__ import annotations

from glob import glob
from pathlib import Path
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch

from yolopoint_tpu_torch.data import gif, pam, pfm, radiance, sunras, tiff
from yolopoint_tpu_torch.data.bmp import SIGNATURE as BMP_SIGNATURE, read_bmp
from yolopoint_tpu_torch.data.errors import Unreadable
from yolopoint_tpu_torch.data.jpeg import SOI, read_jpeg
from yolopoint_tpu_torch.data.native import resize_for
from yolopoint_tpu_torch.data.netpbm import is_netpbm, read_netpbm
from yolopoint_tpu_torch.data.png import SIGNATURE as PNG_SIGNATURE, read_png
from yolopoint_tpu_torch.ops.resize import resize_like_cv2


def _is_avif(head: bytes) -> bool:
    """An ISO-BMFF `ftyp` box whose major or compatible brands name AVIF."""
    if head[4:8] != b"ftyp":
        return False
    size = min(int.from_bytes(head[:4], "big"), len(head))
    brands = [head[8:12]] + [head[i:i + 4] for i in range(16, size - 3, 4)]
    return b"avif" in brands or b"avis" in brands


# The formats that `cv2.imread` decodes here (OpenCV 5.0 of the JAX
# package's environment: WebP, JPEG 2000 and AVIF; no OpenEXR) and the port
# does not read yet, by the signature each of OpenCV's decoders checks.
# `_imread` raises `NotImplementedError` for them; any other signature that
# no reader of the port takes is a file that `cv2.imread` returns None for.
UNPORTED_SIGNATURES = (
    ("WebP", lambda h: h[:4] == b"RIFF" and h[8:12] == b"WEBP"),
    ("JPEG 2000", lambda h: h[:12] == b"\0\0\0\x0cjP  \r\n\x87\n" or h[:4] == b"\xffO\xffQ"),
    ("AVIF", _is_avif),
)
# The readers by the signature OpenCV's decoder of each format checks
READERS = (
    (lambda h: h.startswith(SOI + b"\xff"), read_jpeg),
    (lambda h: h.startswith(PNG_SIGNATURE), read_png),
    (lambda h: h.startswith(BMP_SIGNATURE), read_bmp),
    (is_netpbm, read_netpbm),
    (lambda h: h[:4] in tiff.SIGNATURES, tiff.read_tiff),
    (lambda h: h.startswith(gif.SIGNATURES), gif.read_gif),
    (lambda h: h.startswith(sunras.SIGNATURE), sunras.read_sunras),
    (pam.is_pam, pam.read_pam),
    (pfm.is_pfm, pfm.read_pfm),
    (lambda h: h.startswith(radiance.SIGNATURES), radiance.read_radiance),
)


def _imread(path: str, device: str | torch.device = "cuda", channels: int = 3) -> np.ndarray:
    """uint8 `(H, W, 3)` BGR image of an image file, as `cv2.imread(path,
    cv2.IMREAD_COLOR)` returns it, or for `channels` 1 the `(H, W, 1)` image
    of `cv2.IMREAD_GRAYSCALE` (each format's own grey path, as each of
    OpenCV's decoders converts). Where `cv2.imread` returns None (no file,
    no decoder for its first bytes, a malformed file or a kind its decoder
    refuses: a reader's `Unreadable`) it raises `FileNotFoundError`, as the
    JAX package's `_imread` does; where `cv2.imread` reads a file that the
    port does not, `NotImplementedError`. `device` cpu decodes in numpy, any other in
    compiled host code."""
    p = Path(path)
    if not p.is_file():
        raise FileNotFoundError(path)
    with p.open("rb") as f:
        head = f.read(64)
    grey = channels != 3
    reader = next((read for match, read in READERS if match(head)), None)
    if reader is None:
        for kind, match in UNPORTED_SIGNATURES:
            if match(head):
                raise NotImplementedError(f"{path}: {kind} files are not read by the port "
                                          "(ROADMAP Queue 1 item 3)")
        raise FileNotFoundError(f"{path}: no image decoder for its first bytes {head[:8]!r}")
    try:
        img = reader(p, device, grey)
    except Unreadable as e:  # a file that `cv2.imread` returns None for
        raise FileNotFoundError(f"{path}: {e}") from e
    return img[..., None] if grey else img


def letterbox(img: np.ndarray, new_shape: int | tuple[int, int], color: int = 114,
              auto: bool = False, stride: int = 32, scaleup: bool = True,
              device: str | torch.device = "cuda"):
    """Aspect-preserving bilinear resize and constant padding (the JAX
    package's `letterbox`). Returns `(image, (ratio_w, ratio_h), (top,
    bottom, left, right))`."""
    shape = img.shape[:2]
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)
    r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
    if not scaleup:
        r = min(r, 1.0)
    new_unpad = (int(round(shape[1] * r)), int(round(shape[0] * r)))
    dw, dh = new_shape[1] - new_unpad[0], new_shape[0] - new_unpad[1]
    if auto:
        dw, dh = dw % stride, dh % stride
    dw /= 2
    dh /= 2
    if shape[::-1] != new_unpad:
        img = resize_for(device)(img, new_unpad[1], new_unpad[0], mode="bilinear")
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    h, w, c = img.shape
    out = np.full((h + top + bottom, w + left + right, c), color, np.uint8)
    out[top:top + h, left:left + w] = img
    if c == 1:  # `cv2.copyMakeBorder` returns a one-channel image without its channel axis
        out = out[..., 0]
    return out, (r, r), (top, bottom, left, right)


def load_yolo_boxes(path: str | Path) -> np.ndarray:
    """A YOLO label file as `(M, 5)` `[cls, cx, cy, w, h]` (normalized)."""
    p = Path(path)
    if not p.exists():
        return np.zeros((0, 5), np.float32)
    rows = [[float(v) for v in line.split()[:5]] for line in p.read_text().splitlines()
            if len(line.split()) >= 5]
    return np.asarray(rows, np.float32) if rows else np.zeros((0, 5), np.float32)


def load_points_npz(path: str | Path | None) -> np.ndarray:
    """A keypoint pseudo-label file as `(N, 2)` or `(N, 3)` `[x, y(, prob)]`."""
    if path is None or not Path(path).exists():
        return np.zeros((0, 2), np.float32)
    return np.load(path)["pts"].astype(np.float32)


class ImagePointBoxDataset:
    """Images with optional boxes and keypoints (the JAX package's class of
    the same name; config keys as the reference YAML: `dataset`, `suffix`,
    `preprocessing.img_size`, `labels.points`, `augmentation.mosaic`,
    `augmentation.homographic.cropHW` / `device_crop`, `cache_images`)."""

    letterbox_resize = True
    remove_dontcare = False

    def __init__(self, config: Mapping[str, Any], action: str = "train",
                 names: Sequence[str] = (), root: str | Path = "datasets", debug: bool = False,
                 device: str | torch.device = "cuda"):
        self.config = dict(config)
        self.action = "train" if "train" in action and not debug else "val"
        self.img_size = int(config["preprocessing"]["img_size"])
        self.names = list(names)
        aug = config.get("augmentation") or {}
        self.mosaic_prob = float(aug.get("mosaic") or 0.0)
        hom = aug.get("homographic") or {}
        crop = hom.get("cropHW")
        self.crop_hw = tuple(crop) if crop else None
        # device_crop: the full resized frame and a crop corner; the warp and
        # the crop run on the device (the homography_big chain)
        self.device_crop = bool(hom.get("device_crop", True)) and self.crop_hw is not None
        self._big_hw: Optional[tuple[int, int]] = None
        self.inp_ch = int(config.get("input_channels", 3))
        self.cache_images = bool(config.get("cache_images", False))
        self._img_cache: dict[int, np.ndarray] = {}
        self._label_cache: dict[int, np.ndarray] = {}
        self.dc_idx = next((i for i, s in enumerate(self.names) if s.lower() == "dontcare"),
                           None)
        dataset = config["dataset"].lower()
        suffix = config.get("suffix", ".png")
        suffixes = [suffix] if isinstance(suffix, str) else list(suffix)
        self.device = torch.device(device)
        self._resize_u8 = resize_for(self.device)
        if self.device.type != "cpu":
            from yolopoint_tpu_torch.ops import _build

            _build.library()  # the compiled host code, built now or raising

        data_dir = Path(root) / dataset
        siz = str(self.img_size) if (data_dir / f"images{self.img_size}").is_dir() else ""
        img_dir = data_dir / f"images{siz}" / self.action
        self.img_paths: list[str] = sorted(
            p for s in suffixes for p in glob(str(img_dir / f"*{s}")))
        if not self.img_paths:
            raise FileNotFoundError(f"no images under {img_dir}")
        lbl_dir = data_dir / f"labels{siz}" / self.action
        if not lbl_dir.is_dir():
            lbl_dir = data_dir / "labels" / self.action
        self.label_dir = lbl_dir if lbl_dir.is_dir() else None
        self.point_paths: list[Optional[str]] = [None] * len(self.img_paths)
        if points_dir := (config.get("labels") or {}).get("points"):
            found = sorted(glob(str(Path(points_dir) / self.action / "*.npz")))
            if found:
                by_stem = {Path(p).stem: p for p in found}
                self.point_paths = [by_stem.get(Path(ip).stem) for ip in self.img_paths]
        if debug:
            self.img_paths = self.img_paths[:512]
            self.point_paths = self.point_paths[:512]

    def __len__(self) -> int:
        return len(self.img_paths)

    def _load_raw(self, idx: int):
        if self.cache_images and idx in self._img_cache:
            img = self._img_cache[idx]
        else:
            img = _imread(self.img_paths[idx], self.device, self.inp_ch)
            if self.cache_images:
                self._img_cache[idx] = img
        if idx in self._label_cache:
            boxes = self._label_cache[idx]
        else:
            boxes = np.zeros((0, 5), np.float32)
            if self.label_dir is not None:
                boxes = load_yolo_boxes(self.label_dir / (Path(self.img_paths[idx]).stem + ".txt"))
            if self.remove_dontcare and self.dc_idx is not None and len(boxes):
                boxes = boxes[boxes[:, 0] != self.dc_idx]
            self._label_cache[idx] = boxes
        points = load_points_npz(self.point_paths[idx])
        return img.copy() if self.cache_images else img, boxes.copy(), \
            points[:, :2] if points.size else np.zeros((0, 2), np.float32)

    def _fit_longer_side(self, img: np.ndarray):
        """The image resized so its longer side is `img_size`, and the ratio."""
        h0, w0 = img.shape[:2]
        r = self.img_size / max(h0, w0)
        if r != 1.0:
            img = self._resize_u8(img, int(round(h0 * r)), int(round(w0 * r)))
        return img, r

    def _canvas(self, img: np.ndarray) -> np.ndarray:
        """`img` on the static full-frame canvas (the first sample's size
        rounded up to /32), padded bottom and right with 114."""
        h, w = img.shape[:2]
        if self._big_hw is None:
            self._big_hw = (-(-h // 32) * 32, -(-w // 32) * 32)
        Hb, Wb = self._big_hw
        canvas = np.full((Hb, Wb, img.shape[2]), 114, img.dtype)
        canvas[:min(h, Hb), :min(w, Wb)] = img[:min(h, Hb), :min(w, Wb)]
        return canvas

    def _resize_full(self, img: np.ndarray) -> np.ndarray:
        """Export-mode resize: longer side to `img_size`, padded to the canvas."""
        return self._canvas(self._fit_longer_side(img)[0])

    def iter_export(self):
        """`(name, float image)` pairs for the pseudo-label export."""
        for idx in range(len(self)):
            img, _, _ = self._load_raw(idx)
            yield Path(self.img_paths[idx]).stem, \
                self._resize_full(img).astype(np.float32) / 255.0

    def _crop_corner(self, h: int, w: int, ch: int, cw: int, rng: np.random.RandomState):
        if self.action == "val":
            return (h - ch) // 2, (w - cw) // 2
        y = rng.randint(0, h - ch + 1)
        x = rng.randint(0, w - cw + 1)
        return y, x

    def _resize_big(self, img, boxes, points, rng):
        """Device-crop path: the resized frame on the canvas and a crop
        corner; boxes renormalized to the canvas, points scaled."""
        h0, w0 = img.shape[:2]
        img, r = self._fit_longer_side(img)
        canvas = self._canvas(img)
        Hb, Wb = self._big_hw
        h, w = min(img.shape[0], Hb), min(img.shape[1], Wb)
        ch, cw = self.crop_hw
        y, x = self._crop_corner(h, w, min(ch, h), min(cw, w), rng)
        if len(points):
            points = points * r
        if len(boxes):
            b = boxes.copy()
            b[:, 1] = boxes[:, 1] * w0 * r / Wb
            b[:, 2] = boxes[:, 2] * h0 * r / Hb
            b[:, 3] = boxes[:, 3] * w0 * r / Wb
            b[:, 4] = boxes[:, 4] * h0 * r / Hb
            boxes = b
        return canvas, boxes, points, (0, 0, 0, 0), np.array([y, x], np.float32)

    def _resize(self, img, boxes, points, rng):
        """Letterbox (COCO) or a host crop (KITTI) to a static shape."""
        h0, w0 = img.shape[:2]
        if self.crop_hw:
            img, r = self._fit_longer_side(img)
            h, w = img.shape[:2]
            ch, cw = self.crop_hw
            ch, cw = min(ch, h), min(cw, w)
            y, x = self._crop_corner(h, w, ch, cw, rng)
            img = img[y:y + ch, x:x + cw]
            if len(points):
                points = points * r - np.array([x, y], np.float32)
                inside = ((points[:, 0] >= 0) & (points[:, 0] < cw)
                          & (points[:, 1] >= 0) & (points[:, 1] < ch))
                points = points[inside]
            if len(boxes):
                xyxy = boxes[:, 1:].copy()
                xyxy[:, 0::2] = xyxy[:, 0::2] * w0
                xyxy[:, 1::2] = xyxy[:, 1::2] * h0
                xyxy[:, 0] = xyxy[:, 0] * r - x
                xyxy[:, 1] = xyxy[:, 1] * r - y
                xyxy[:, 2:] *= r
                keep = ((xyxy[:, 0] > 0) & (xyxy[:, 0] < cw)
                        & (xyxy[:, 1] > 0) & (xyxy[:, 1] < ch))
                boxes = np.concatenate(
                    [boxes[keep, :1], xyxy[keep] / np.array([cw, ch, cw, ch], np.float32)],
                    axis=1)
            return img, boxes, points, (0, 0, 0, 0)
        if self.letterbox_resize:
            img, (rw, rh), (top, bottom, left, right) = letterbox(img, self.img_size,
                                                                  device=self.device)
            h, w = img.shape[:2]
            if len(points):
                points = points * rw + np.array([left, top], np.float32)
            if len(boxes):
                b = boxes.copy()
                b[:, 1] = (boxes[:, 1] * w0 * rw + left) / w
                b[:, 2] = (boxes[:, 2] * h0 * rh + top) / h
                b[:, 3] = boxes[:, 3] * w0 * rw / w
                b[:, 4] = boxes[:, 4] * h0 * rh / h
                boxes = b
            return img, boxes, points, (top, bottom, left, right)
        return img, boxes, points, (0, 0, 0, 0)

    def _mosaic(self, idx: int, rng: np.random.RandomState):
        """Four final-size samples (this one and three drawn) in a shuffled
        2x2 on a `(2H, 2W)` canvas; the warp and the centre `(H, W)` crop at
        `(H // 2, W // 2)` run on the device."""
        idxs = [idx] + list(rng.randint(0, len(self), 3))
        rng.shuffle(idxs)
        all_boxes, all_points = [], []
        canvas = None
        th = tw = None
        for i, ti in enumerate(idxs):
            img, boxes, points, _ = self._resize(*self._load_raw(ti), rng)
            if canvas is None:
                th, tw = img.shape[:2]
                canvas = np.full((2 * th, 2 * tw, img.shape[2]), 114, img.dtype)
            oy, ox = (i // 2) * th, (i % 2) * tw
            canvas[oy:oy + th, ox:ox + tw] = img[:th, :tw]
            if len(points):
                all_points.append(points + np.array([ox, oy], np.float32))
            if len(boxes):
                b = boxes.copy()
                b[:, 1] = (boxes[:, 1] * tw + ox) / (2 * tw)
                b[:, 2] = (boxes[:, 2] * th + oy) / (2 * th)
                b[:, 3] = boxes[:, 3] / 2
                b[:, 4] = boxes[:, 4] / 2
                all_boxes.append(b)
        points = np.concatenate(all_points) if all_points else np.zeros((0, 2), np.float32)
        boxes = np.concatenate(all_boxes) if all_boxes else np.zeros((0, 5), np.float32)
        return canvas, boxes, points, (0, 0, 0, 0), np.array([th // 2, tw // 2], np.float32)

    def get(self, idx: int, mosaic: Optional[bool] = None,
            rng: Optional[np.random.RandomState] = None) -> dict[str, Any]:
        """One decoded sample of static shape. `mosaic` overrides the
        per-sample draw (the loader decides per batch); `rng` draws the crop
        corners, the mosaic's tiles and that Bernoulli (default: a
        `RandomState` seeded by `idx`). A crop sample carries `crop_yx`, a
        mosaic `mosaic_crop_yx`."""
        if rng is None:
            rng = np.random.RandomState(idx)
        if mosaic is None:
            mosaic = (self.action == "train" and self.mosaic_prob
                      and rng.random_sample() < self.mosaic_prob)
        crop_yx = crop_key = None
        if mosaic:
            img, boxes, points, pad, crop_yx = self._mosaic(idx, rng)
            crop_key = "mosaic_crop_yx"
        elif self.device_crop:
            img, boxes, points, pad, crop_yx = self._resize_big(*self._load_raw(idx), rng)
            crop_key = "crop_yx"
        else:
            img, boxes, points, pad = self._resize(*self._load_raw(idx), rng)
        sample = {"image": img.astype(np.float32) / 255.0, "boxes": boxes, "points": points,
                  "pad": pad, "name": Path(self.img_paths[idx]).stem}
        if crop_yx is not None:
            sample[crop_key] = crop_yx
        return sample


class Coco(ImagePointBoxDataset):
    """Letterboxed COCO."""

    letterbox_resize = True


class Kitti(ImagePointBoxDataset):
    """KITTI: a fixed crop, DontCare boxes removed."""

    letterbox_resize = False
    remove_dontcare = True


class Campus(Kitti):
    """KITTI without the DontCare removal."""

    remove_dontcare = False


DATASET_REGISTRY = {"coco": Coco, "kitti": Kitti, "campus": Campus}
SYNTHETIC_NAMES = ("synthetic_shapes", "synthetic")


def build_dataset(config, action="train", names=(), root="datasets", debug=False,
                  device: str | torch.device = "cuda"):
    """The dataset `config["dataset"]` names: `synthetic_shapes` (or
    `synthetic`) gives `SyntheticShapes`, `coco` / `kitti` / `campus` their
    classes, any other name an `ImagePointBoxDataset` on `<root>/<name>`.
    `device` is where the batches go: the CPU decodes in numpy."""
    name = str(config["dataset"]).lower()
    if name in SYNTHETIC_NAMES:
        from yolopoint_tpu_torch.data.synthetic import SyntheticShapes

        return SyntheticShapes(config, action=action, names=names, root=root, debug=debug)
    cls = DATASET_REGISTRY.get(name, ImagePointBoxDataset)
    return cls(config, action=action, names=names, root=root, debug=debug, device=device)


class HPatches:
    """HPatches sequences: per pair `(img1, imgN, H_1_N)`, each image resized
    to cover `size_hw` at its aspect ratio and center-cropped, the
    homography adapted to both preprocessings."""

    def __init__(self, root: str | Path, size_hw: tuple[int, int] = (480, 640),
                 alteration: str = "all"):
        self.root = Path(root)
        self.size_hw = size_hw
        self.pairs: list[tuple[Path, Path, Path]] = []
        for scene in sorted(self.root.iterdir()):
            if not scene.is_dir():
                continue
            if alteration != "all" and not scene.name.startswith(alteration):
                continue
            base = scene / "1.ppm"
            for n in range(2, 7):
                img2 = scene / f"{n}.ppm"
                hfile = scene / f"H_1_{n}"
                if base.exists() and img2.exists() and hfile.exists():
                    self.pairs.append((base, img2, hfile))

    def __len__(self) -> int:
        return len(self.pairs)

    def _preprocess(self, img: np.ndarray):
        """Scale so the image covers `size_hw`, then center-crop to it."""
        H, W = self.size_hw
        h0, w0 = img.shape[:2]
        scale = max(H / h0, W / w0)
        size = (int(round(w0 * scale)), int(round(h0 * scale)))
        img = resize_like_cv2(torch.from_numpy(img), size, scale).numpy()
        h, w = img.shape[:2]
        top, left = (h - H) // 2, (w - W) // 2
        return img[top:top + H, left:left + W], scale, (top, left)

    def __getitem__(self, idx: int) -> dict[str, Any]:
        p1, p2, hf = self.pairs[idx]
        i1, s1, (t1, l1) = self._preprocess(_imread(str(p1)))
        i2, s2, (t2, l2) = self._preprocess(_imread(str(p2)))
        H12 = np.array([[float(v) for v in line.split()] for line in
                        Path(hf).read_text().split("\n") if line.strip()])
        # x2 = H @ x1 on the originals; x2' = S2 @ H @ S1^-1 @ x1' with S the
        # scale and the crop's translation
        S1 = np.array([[s1, 0, -l1], [0, s1, -t1], [0, 0, 1.0]])
        S2 = np.array([[s2, 0, -l2], [0, s2, -t2], [0, 0, 1.0]])
        return {
            "image": i1.astype(np.float32) / 255.0,
            "warped_image": i2.astype(np.float32) / 255.0,
            "homography_pix": S2 @ H12 @ np.linalg.inv(S1),
            "name": f"{p1.parent.name}_{p2.stem}",
        }
