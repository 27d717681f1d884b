"""Image-set loading with undistort-at-load semantics.

PyTorch port of recon3d_tpu/io/dataset.py (`ImageSet`, `list_images`,
`load_image_set`): a directory of images sorted by name is read on the host
(PIL), resized so the long side <= max_size, padded to one canvas, and
undistorted on the device through ops/image.undistort_image (K1 on CUDA,
all colour planes of the set in one launch).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from recon3d_tpu_torch.camera import Camera
from recon3d_tpu_torch.io.hostimg import resize_batch_np, rgb_to_gray_np
from recon3d_tpu_torch.ops.image import undistort_image
from recon3d_tpu_torch.runtime.device import resolve_device

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff", ".webp")


@dataclass
class ImageSet:
    """A loaded multi-view image set.

    gray:   (V, H, W) float32 in [0, 1], undistorted.
    color:  (V, H, W, 3) float32 in [0, 1], undistorted.
    camera: shared Camera with K scaled to the working resolution
            (distortion already applied to the pixels).
    names:  original file names.
    sizes:  (V, 2) actual (h, w) of each image inside the padded canvas.
    prescaled: working-scale colour stacks keyed by scale (small_color).
    """

    gray: np.ndarray
    color: np.ndarray
    camera: Camera
    names: List[str]
    sizes: np.ndarray
    scale: float = 1.0
    prescaled: Dict[float, np.ndarray] = field(default_factory=dict)

    def small_color(self, scale: float) -> np.ndarray:
        """(V, H*scale, W*scale, 3) float32 color stack, cached per scale."""
        key = round(float(scale), 6)
        if key not in self.prescaled:
            h = int(self.color.shape[1] * scale)
            w = int(self.color.shape[2] * scale)
            self.prescaled[key] = resize_batch_np(self.color, (h, w))
        return self.prescaled[key]


def list_images(image_dir: str) -> List[str]:
    return sorted(
        f
        for f in os.listdir(image_dir)
        if f.lower().endswith(IMAGE_EXTS)
    )


def _round_to(v: int, m: int) -> int:
    return max(m, int(np.ceil(v / m) * m))


def focal_px_from_exif(pil_image, width_px: int):
    """Focal length in pixels from EXIF FocalLengthIn35mmFilm (tag 41989),
    f_px = f35 / 36mm * width, or None."""
    try:
        ex = pil_image.getexif()
        f35 = ex.get(41989)
        if f35 is None:
            f35 = ex.get_ifd(0x8769).get(41989)
        if f35:
            f35 = float(f35)
            if 10.0 <= f35 <= 600.0:
                return f35 * float(width_px) / 36.0
    except (AttributeError, KeyError, TypeError, ValueError):
        pass
    return None


def load_image_set(
    image_dir: str,
    camera: Optional[Camera] = None,
    max_size: int = 1600,
    max_images: Optional[int] = None,
    pad_multiple: int = 16,
    device="cuda",
) -> ImageSet:
    """Load, resize, undistort a directory of images into padded arrays.
    Undistortion (when camera.dist is non-zero) runs on `device`."""
    from PIL import Image

    files = list_images(image_dir)
    if max_images:
        files = files[:max_images]
    if not files:
        raise FileNotFoundError(f"no images in {image_dir}")

    raw: List[np.ndarray] = []
    exif_focal_px = None
    first_scale = 1.0
    for f in files:
        im = Image.open(os.path.join(image_dir, f)).convert("RGB")
        w, h = im.size
        scale = min(1.0, max_size / max(w, h))
        if not raw:
            first_scale = scale
        if exif_focal_px is None:
            exif_focal_px = focal_px_from_exif(
                im, int(round(w * min(scale, 1.0)))
            )
        if scale < 1.0:
            im = im.resize((int(round(w * scale)), int(round(h * scale))), Image.BILINEAR)
        raw.append(np.asarray(im, dtype=np.float32) / 255.0)

    H = _round_to(max(r.shape[0] for r in raw), pad_multiple)
    W = _round_to(max(r.shape[1] for r in raw), pad_multiple)

    color = np.zeros((len(raw), H, W, 3), np.float32)
    sizes = np.zeros((len(raw), 2), np.int32)
    for i, r in enumerate(raw):
        color[i, : r.shape[0], : r.shape[1]] = r
        sizes[i] = (r.shape[0], r.shape[1])

    if camera is None:
        f = exif_focal_px or 1.2 * max(H, W)
        if exif_focal_px:
            print(f"[load] EXIF focal: {f:.1f} px")
        camera = Camera.create(fx=f, fy=f, cx=W / 2.0, cy=H / 2.0)
    elif first_scale < 1.0:
        camera = camera.scaled(first_scale)

    has_dist = bool(torch.any(torch.abs(camera.dist) > 1e-12))
    if has_dist:
        # uint8 to the device and back, as the JAX version ships it
        dev = resolve_device(device)
        u8 = np.clip(color * 255.0, 0.0, 255.0).astype(np.uint8)
        img = torch.from_numpy(u8).to(dev).to(torch.float32) / 255.0
        und = undistort_image(img, camera.K, camera.dist)
        und = torch.clamp(und * 255.0, 0.0, 255.0).to(torch.uint8)
        color = und.cpu().numpy().astype(np.float32) / 255.0
        camera = Camera(K=camera.K, dist=torch.zeros_like(camera.dist))

    return ImageSet(
        gray=rgb_to_gray_np(color),
        color=color,
        camera=camera,
        names=files,
        sizes=sizes,
        scale=first_scale,
    )
