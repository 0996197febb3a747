"""Host-side image loading (port of rpe_tpu/io/image_loader.py).

Frames are decoded on the host by the native batched decoder (io/native).
Grayscale uses the ITU-R BT.601 weights of cv2.cvtColor(BGR2GRAY) with
PIL's integer rounding, so 8-bit values match the reference bit for bit.

Unlike the reference, which falls back to PIL on any exception of the
native path, the port uses PIL in exactly two cases: a JPEG variant the
native decoder does not cover (progressive), and `RPE_NO_NATIVE_LOADER=1`.
PIL is imported only then; where it is absent (the card machine has none)
the ImportError names the file. A failed build or load of the decoder
raises. `DECODES` counts the frames each way decoded.
"""

from __future__ import annotations

import os

import numpy as np

from . import native

DECODES = {"native": 0, "pil": 0}


def reset_decodes() -> None:
    for k in DECODES:
        DECODES[k] = 0


def _pil(path):
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"decoding {path} needs PIL, which is not installed (the native "
            f"decoder covers PNGs and baseline JPEGs; unset "
            f"RPE_NO_NATIVE_LOADER to use it)") from e
    return Image


def load_image(path, to_gray: bool = True) -> np.ndarray:
    """Load one image with PIL; grayscale uint8 (H, W) by default, else BGR
    (H, W, 3). FileNotFoundError if the file is missing or unreadable."""
    Image = _pil(path)
    try:
        img = Image.open(path)
        img.load()
    except OSError as e:
        raise FileNotFoundError(f"Could not read image from: {path}") from e
    DECODES["pil"] += 1
    if to_gray:
        # PIL 'L' = round(0.299 R + 0.587 G + 0.114 B), cv2's BGR2GRAY weights
        if img.mode != "L":
            img = img.convert("L")
        return np.asarray(img, dtype=np.uint8)
    arr = np.asarray(img.convert("RGB"), dtype=np.uint8)
    return arr[..., ::-1]  # BGR channel order for reference compatibility


def load_image_pair(path1, path2, to_gray: bool = True):
    """Load two images."""
    return load_image(path1, to_gray), load_image(path2, to_gray)


def load_image_batch(paths, to_gray: bool = True) -> np.ndarray:
    """Load same-shape images into one (N, H, W) (or (N, H, W, 3)) array
    with the native decoder."""
    paths = [str(p) for p in paths]
    if not os.environ.get("RPE_NO_NATIVE_LOADER"):
        try:
            out = native.decode_batch(paths, to_gray=to_gray)
        except native.UnsupportedImage:
            pass
        else:
            DECODES["native"] += len(paths)
            return out
    return np.stack([load_image(p, to_gray) for p in paths])


class LazyFrameSource:
    """Per-chunk lazy decode with a small LRU frame cache.

    Decodes only the indices a chunk asks for, so host RAM stays O(chunk)
    (KITTI seq 00 decoded eagerly is ~8.5 GB at f32) and pipeline/batch.py
    can decode chunk c+1 while chunk c runs. The cache keeps the last ~2
    chunks of frames, so the one-frame overlap between consecutive chunks is
    never decoded twice.

    Indexable like the eager array for the read patterns batch.py uses:
    `src[list_or_2d_index_array]` -> float32 (.., H, W).
    """

    def __init__(self, paths, to_gray: bool = True, cache_frames: int = 256):
        self.paths = [str(p) for p in paths]
        self.to_gray = to_gray
        self.cache_frames = cache_frames
        self._cache: dict[int, np.ndarray] = {}  # insertion-ordered LRU

    def __len__(self):
        return len(self.paths)

    def get(self, indices) -> np.ndarray:
        idx = np.asarray(indices)
        flat = [int(i) for i in idx.reshape(-1)]
        need = set(flat)
        if len(need) > self.cache_frames:  # oversize request: bypass cache
            order = sorted(need)
            imgs = load_image_batch([self.paths[i] for i in order],
                                    to_gray=self.to_gray)
            table = {i: np.asarray(im, dtype=np.float32)
                     for i, im in zip(order, imgs)}
            out = np.stack([table[i] for i in flat])
            return out.reshape(*idx.shape, *out.shape[1:])
        missing = sorted(i for i in need if i not in self._cache)
        if missing:
            imgs = load_image_batch([self.paths[i] for i in missing],
                                    to_gray=self.to_gray)
            for i, im in zip(missing, imgs):
                self._cache[i] = np.asarray(im, dtype=np.float32)
        for i in need:  # refresh LRU position of every hit
            self._cache[i] = self._cache.pop(i)
        while len(self._cache) > self.cache_frames:
            evict = next(i for i in self._cache if i not in need)
            self._cache.pop(evict)
        out = np.stack([self._cache[i] for i in flat])
        return out.reshape(*idx.shape, *out.shape[1:])

    def __getitem__(self, indices):
        if isinstance(indices, slice):
            indices = list(range(*indices.indices(len(self))))
        return self.get(indices)
