"""Image loading/saving (host-side; twin of ``aerial_mapper_tpu/io/images.py``).

Replaces ``io::AerialMapperIO::loadImagesFromFile`` (``aerial_mapper_io/src/
aerial-mapper-io.cc:207-249``): load by ``prefix + index + ".jpg"`` or by an
explicit name list, grayscale or color, as float32 numpy arrays in
[0, 255]. The port decodes with PIL, imported only when a file is read or
written (so the module imports without it): the JAX package's ``"pil"``
backend. Its thread-pool native loader is not ported.
"""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np


def _load_one(path: str, color: bool) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as img:
        img = img.convert("RGB" if color else "L")
        return np.asarray(img, dtype=np.float32)


def load_images_by_prefix(
    filename_base: str,
    num_poses: int,
    color: bool = False,
    extension: str = ".jpg",
) -> List[np.ndarray]:
    """Load ``filename_base + str(i) + extension`` for i in [0, num_poses)
    (aerial-mapper-io.cc:207-227)."""
    paths = []
    for i in range(num_poses):
        path = f"{filename_base}{i}{extension}"
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        paths.append(path)
    if not paths:
        raise ValueError("No images loaded.")
    return [_load_one(p, color) for p in paths]


def load_images_by_names(
    directory: str,
    image_names: Sequence[str],
    color: bool = False,
    extension: str = ".png",
) -> List[np.ndarray]:
    """Load ``directory/name + extension`` per name (aerial-mapper-io.cc:229-249).
    Names that already carry an extension are used as-is."""
    paths = [
        os.path.join(directory,
                     name if os.path.splitext(name)[1] else name + extension)
        for name in image_names
    ]
    if not paths:
        raise ValueError("No images loaded.")
    return [_load_one(p, color) for p in paths]


def save_image(path: str, array: np.ndarray) -> None:
    """Write a uint8 image ATOMICALLY (temp file + rename): a live preview
    may read the path while the mapping loop rewrites it, and an in-place
    write would serve torn PNGs."""
    from PIL import Image

    arr = np.clip(np.asarray(array), 0, 255).astype(np.uint8)
    d, base = os.path.split(path)
    tmp = os.path.join(d, f".tmp{os.getpid()}_{base}")
    Image.fromarray(arr).save(tmp)
    os.replace(tmp, path)
