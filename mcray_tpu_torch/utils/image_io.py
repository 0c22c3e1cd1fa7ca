"""Host-side image output — replaces the reference's OpenCV imshow/imwrite
GUI path (reference: src/rfimage.h:142-159) with headless PNG saving."""

from __future__ import annotations

import numpy as np


def to_u8(img: np.ndarray) -> np.ndarray:
    """Float [0,1] -> u8, matching cv::Mat::convertTo(CV_8U, 255) saturation
    (src/rfimage.h:146): scale, round-half-to-even, clamp; NaN -> 0."""
    x = np.asarray(img, np.float64) * 255.0
    x = np.nan_to_num(x, nan=0.0)
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


def save_png(path: str, img: np.ndarray) -> None:
    arr = to_u8(img)
    try:
        from PIL import Image

        Image.fromarray(arr, mode="L").save(path)
    except ImportError:  # minimal fallback: binary PGM (no extra deps)
        pgm = path if path.endswith(".pgm") else path + ".pgm"
        with open(pgm, "wb") as f:
            f.write(b"P5\n%d %d\n255\n" % (arr.shape[1], arr.shape[0]))
            f.write(arr.tobytes())
