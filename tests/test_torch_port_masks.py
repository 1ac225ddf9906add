"""robosat_tpu_torch's `masks` vs the JAX package's `rs masks`.

Both tools read the same probability PNGs (palette indices, as `predict`
writes them); their masks must be byte-equal PNG pixels with the same
palette, for one tileset and for a weighted and an unweighted soft vote
over three, with the p == 1.0 saturation wrap (index 0) read back as 1.0.
"""

import argparse

import numpy as np
import pytest
from PIL import Image

from robosat_tpu.colors import continuous_palette_for_color
from robosat_tpu.tools import masks as jax_masks
from robosat_tpu_torch.tools import masks

TILES = [(69623, 104945, 18), (69623, 104946, 18), (69624, 104945, 18)]


def _write_probs(root, seed):
    """A probability tileset: random indices, some saturated (index 0) and
    some at p == 0.0 (index 1, read back as 1/255)."""
    rng = np.random.default_rng(seed)
    palette = continuous_palette_for_color("pink", 256)
    for x, y, z in TILES:
        q = rng.integers(0, 256, (32, 32), dtype=np.uint8)
        q[:4] = 0
        q[4:6] = 1
        d = root / str(z) / str(x)
        d.mkdir(parents=True, exist_ok=True)
        img = Image.fromarray(q, mode="P")
        img.putpalette(palette)
        img.save(str(d / "{}.png".format(y)), optimize=False, compress_level=1)
    return str(root)


@pytest.mark.parametrize("sets,weights", [(1, None), (3, None), (3, [0.2, 1.5, 0.7])],
                         ids=["one", "unweighted", "weighted"])
def test_masks_tool_matches_jax(tmp_path, sets, weights):
    probs = [_write_probs(tmp_path / "probs{}".format(i), seed=i) for i in range(sets)]
    for module, out in ((masks, "masks_torch"), (jax_masks, "masks_jax")):
        module.main(argparse.Namespace(masks=str(tmp_path / out), probs=probs, weights=weights))
    for x, y, z in TILES:
        rel = "{}/{}/{}.png".format(z, x, y)
        got, ref = Image.open(tmp_path / "masks_torch" / rel), Image.open(tmp_path / "masks_jax" / rel)
        assert got.mode == ref.mode == "P" and got.getpalette() == ref.getpalette()
        assert np.array_equal(np.asarray(got), np.asarray(ref))
        if sets == 1:
            # The un-wrap: saturated rows are foreground, p == 0.0 rows background.
            assert np.all(np.asarray(got)[:4] == 1) and np.all(np.asarray(got)[4:6] == 0)


def test_load_probs_unwraps_saturation(tmp_path):
    root = _write_probs(tmp_path / "probs", seed=3)
    path = "{}/18/69623/104945.png".format(root)
    got, ref = masks._load_probs(path), jax_masks._load_probs(path)
    assert got.shape == ref.shape == (2, 32, 32)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert np.all(got[1, :4] == 1.0) and np.all(got[1, 4:6] == 1.0 / 255.0)
    stacked = np.stack([got, 1.0 - got])
    assert np.array_equal(masks.softvote(stacked, axis=0, weights=[2.0, 1.0]),
                          jax_masks.softvote(stacked, axis=0, weights=[2.0, 1.0]))
