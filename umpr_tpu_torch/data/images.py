"""Host-side image pipeline: JPEG decode + resize -> uint8 NHWC batches
(port of umpr_tpu/data/images.py).

As in the reference (src/dataset.py:134-151): cv2.imread, bilinear resize
to `resize`, BGR -> RGB; an unreadable file gives zeros, and so does the
empty path of a missing photo slot.  No ImageNet mean/std normalisation:
the model divides by 255 on the device.

cv2 is imported when a photo is decoded.  Where it is missing, a
non-empty path raises ImportError (the JAX package returns zeros there).
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np


def get_image(path, resize=(224, 224)):
    """Decode one image to uint8 (H, W, 3) RGB; zeros for '' and for a
    file cv2 cannot read."""
    if not path:
        return np.zeros((resize[1], resize[0], 3), dtype=np.uint8)
    import cv2
    try:
        image = cv2.imread(path)
        image = cv2.resize(image, resize)  # bilinear, as in the reference
        return cv2.cvtColor(image, cv2.COLOR_BGR2RGB)
    except Exception:
        return np.zeros((resize[1], resize[0], 3), dtype=np.uint8)


class PhotoCache:
    """LRU cache of decoded, resized photos, keyed by (path, resize).

    Every sample of an item reuses the item's photos, so after one pass the
    working set is the unique photos.  Thread-safe: the train and eval
    loaders' prefetch threads share one cache; decodes run outside the
    lock."""

    def __init__(self, capacity_bytes=2 << 30):
        self._d = OrderedDict()
        self._capacity = capacity_bytes
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, path, resize):
        key = (path, resize)
        with self._lock:
            img = self._d.get(key)
            if img is not None:
                self._d.move_to_end(key)
                self.hits += 1
                return img
            self.misses += 1
        img = get_image(path, resize)
        with self._lock:
            if key not in self._d:
                self._bytes += img.nbytes
                self._d[key] = img
                while self._bytes > self._capacity and self._d:
                    _, old = self._d.popitem(last=False)
                    self._bytes -= old.nbytes
        return img


def load_photo_batch(paths, resize=(224, 224), executor=None, cache=None):
    """paths: (B, V, P) array of path strings -> (B, V, P, H, W, 3) uint8.
    With an executor the unique paths are decoded in parallel (into the
    cache, when there is one)."""
    b, v, p = paths.shape
    flat = paths.reshape(-1)
    if cache is not None:
        if executor is not None:
            list(executor.map(lambda s: cache.get(s, resize), set(flat)))
        imgs = [cache.get(s, resize) for s in flat]
    elif executor is not None:
        imgs = list(executor.map(lambda s: get_image(s, resize), flat))
    else:
        imgs = [get_image(s, resize) for s in flat]
    return np.stack(imgs).reshape(b, v, p, resize[1], resize[0], 3)
