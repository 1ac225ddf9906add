"""Buffered slippy-map tiles for `predict`, numpy-first.

Counterpart of robosat_tpu/data/datasets.py, limited to what `predict`
uses: `BufferedSlippyMapDirectory` with its `--shard` slice and the native
decode. The column strips of `--strip > 1` are not ported yet (ROADMAP
Queue 1, item 4). Indexable + length, so it plugs into the threaded
prefetch loader (robosat_tpu_torch/data/loader.py).
"""

import collections
import threading

import numpy as np
from PIL import Image

from robosat_tpu_torch.native import imagecodec
from robosat_tpu_torch.tiles import buffer_tile_image, tiles_from_slippy_map


def _decode_rgb(path):
    """Decode a tile to (H, W, 3) uint8: the native codec, with PIL for
    anything it declines."""
    decoded = imagecodec.decode_rgb(path)
    if decoded is None:
        with Image.open(path) as img:
            decoded = np.asarray(img.convert("RGB"))
    return decoded


def _shard_slice(items, shard):
    """The `i`-th of `n` contiguous blocks of a deterministic item list.

    Contiguous (not strided) so a shard keeps the column-major traversal
    locality the decode LRU relies on, and so the union over all shards is
    exactly the full list with no overlap: the basis of `predict --shard i/n`.
    """
    i, n = shard
    if not (0 <= i < n):
        raise ValueError("shard index {} out of range for {} shards".format(i, n))
    lo = i * len(items) // n
    hi = (i + 1) * len(items) // n
    return items[lo:hi]


class BufferedSlippyMapDirectory:
    """Tiles composited with `overlap` pixels of 3x3-neighbor context.

    Contract parity: robosat/datasets.py:83-136 (assertions included); the
    overlap crop happens on the device in the predict step.
    """

    def __init__(self, root, size=512, overlap=32, cache_tiles=256, transform=None, shard=None):
        assert overlap >= 0
        # The reference asserts size >= 256 (robosat/datasets.py:104); relaxed
        # to the model's minimum so small tiles remain testable on CPU.
        assert size >= 32

        self.size = size
        self.overlap = overlap
        self.transform = transform
        self.tiles = list(tiles_from_slippy_map(root))
        # Neighbor context always comes from the FULL directory, so sharding
        # only the center-tile list keeps every shard's output byte-identical
        # to the corresponding slice of an unsharded run.
        self._by_tile = dict(self.tiles)
        if shard is not None:
            self.tiles = _shard_slice(self.tiles, shard)

        # Buffering reads every tile up to 9x (once as center, 8x as a
        # neighbor); an LRU over decoded tiles makes that ~1 decode per tile
        # for the sorted column-major traversal.
        self._cache = collections.OrderedDict()
        self._cache_limit = cache_tiles
        self._lock = threading.Lock()

    def __len__(self):
        return len(self.tiles)

    def _load_cached(self, path):
        with self._lock:
            if path in self._cache:
                self._cache.move_to_end(path)
                return self._cache[path]
        decoded = _decode_rgb(path)
        with self._lock:
            self._cache[path] = decoded
            if len(self._cache) > self._cache_limit:
                self._cache.popitem(last=False)
        return decoded

    def __getitem__(self, i):
        tile, _ = self.tiles[i]
        image = buffer_tile_image(
            tile, self._by_tile, overlap=self.overlap, tile_size=self.size, load=self._load_cached
        )
        if self.transform is not None:
            image = self.transform(image)
        return image, tile
