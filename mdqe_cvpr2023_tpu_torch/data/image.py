"""Image reading and resizing for the host data path, with OpenCV, else
Pillow, in the JAX package's order (``data/dataset.py::read_image``,
``data/augmentation.py``, ``engine/trainer.py::_resize``). ``BACKEND`` names
the one in use.
"""
from __future__ import annotations

import numpy as np

try:
    import cv2
    BACKEND = "cv2"
except ImportError:
    cv2 = None
    from PIL import Image
    BACKEND = "PIL"


def read_image(path: str) -> np.ndarray:
    """RGB uint8 (H, W, 3)."""
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(f"could not read image: {path}")
        return img[:, :, ::-1].copy()
    return np.asarray(Image.open(path).convert("RGB"))


def size_for_test(h: int, w: int, min_test: int, max_test: int):
    """The (h, w) an image of size (h, w) is resized to for testing: the
    short side to ``min_test`` unless the long side would pass ``max_test``."""
    scale = min_test / min(h, w)
    if max(h, w) * scale > max_test:
        scale = max_test / max(h, w)
    return int(round(h * scale)), int(round(w * scale))


def resize_image(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear (OpenCV INTER_LINEAR, or Pillow BILINEAR)."""
    if cv2 is not None:
        return cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
    return np.asarray(Image.fromarray(img).resize((w, h), Image.BILINEAR))


def resize_mask(mask: np.ndarray, h: int, w: int) -> np.ndarray:
    """Nearest, to bool."""
    if cv2 is not None:
        return cv2.resize(mask.astype(np.uint8), (w, h),
                          interpolation=cv2.INTER_NEAREST).astype(bool)
    return np.asarray(Image.fromarray(mask.astype(np.uint8)).resize(
        (w, h), Image.NEAREST)).astype(bool)
