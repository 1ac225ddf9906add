"""robosat_tpu_torch's `predict` tool vs the JAX package's.

- `predict` on the same checkpoint and per-site amaxes (a QAT checkpoint's
  `qat_amaxes`) gives the JAX tool's PNGs: equal, or within one bin on at
  most 0.1% of the pixels (bf16: within one bin on >= 99%), through the
  model keys (`pallas_tail = "sep"`, `int8 = false`, `fused_head =
  false`) and the modes (`--strip`, `host_s2d = false`, an odd overlap);
  the port's strips equal its per-tile PNGs in float32; `--profile`
  writes a trace; the unported combinations raise the JAX tool's errors.
- `predict` dispatches ahead and fetches behind: batch k + 1 is issued
  before batch k is fetched, at most three batches are pending, and every
  PNG is written once.

Split from tests/test_torch_port_predict.py (whose `model` fixture and bin
helpers it takes), so that the test runner's per-file workers share the
cases.
"""

import argparse

import numpy as np
import pytest
import torch
from PIL import Image

from robosat_tpu.checkpoint import save_checkpoint
from robosat_tpu.config import save_config
from test_torch_port_predict import _assert_close_bins, _bin_distance, model  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two torch threads for this module: its float32 cases hold 0
    differing pixels against the JAX tool, which the port's float sums
    meet at 2 and 8 threads; at torch_port_refs.TORCH_THREADS (1) one
    pixel of `fp32-strip` lands one bin off."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _predict_args(tmp_path, tiles, probs, checkpoint, **overrides):
    args = dict(
        batch_size=2, checkpoint=checkpoint, overlap=0, strip=1, tile_size=64, workers=2, shard=None,
        tiles=str(tiles), probs=str(probs), model=str(tmp_path / "model.toml"),
        dataset=str(tmp_path / "dataset.toml"), profile=None, png_optimize=False,
    )
    args.update(overrides)
    return argparse.Namespace(**args)


@pytest.fixture(scope="module")
def predict_fixture(tmp_path_factory, model):
    """Two 64-px tiles, a checkpoint and the model/dataset configs."""
    params, state, _, amaxes = model
    root = tmp_path_factory.mktemp("port_predict")
    rng = np.random.default_rng(11)
    for y in (104945, 104946):
        d = root / "tiles" / "18" / "69623"
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)).save(d / "{}.png".format(y))
    checkpoint = str(root / "model.npz")
    save_checkpoint(checkpoint, {"params": params, "state": state}, meta={"epoch": 1})
    qat_checkpoint = str(root / "model_qat.npz")
    save_checkpoint(qat_checkpoint, {"params": params, "state": state},
                    meta={"epoch": 1, "qat_amaxes": [float(a) for a in amaxes]})
    save_config({"common": {"cuda": False, "batch_size": 2, "image_size": 64, "checkpoint": str(root),
                            "bf16": True, "int8": True}}, str(root / "model.toml"))
    save_config({"common": {"dataset": str(root), "classes": ["background", "parking"],
                            "colors": ["denim", "orange"]}}, str(root / "dataset.toml"))
    return root, checkpoint, qat_checkpoint


def test_predict_tool_calibrates_on_first_batch(predict_fixture):
    from robosat_tpu_torch.tools import predict

    root, checkpoint, _ = predict_fixture
    out = predict.main(_predict_args(root, root / "tiles", root / "probs_calibrated", checkpoint))
    assert out["tiles"] == 2 and out["steady_s"] >= 0.0
    pngs = list((root / "probs_calibrated").rglob("*.png"))
    assert len(pngs) == 2
    for path in pngs:
        img = Image.open(path)
        assert img.mode == "P" and img.size == (64, 64)


def test_predict_tool_matches_jax(predict_fixture):
    from robosat_tpu.tools import predict as jax_predict
    from robosat_tpu_torch.tools import predict

    root, _, checkpoint = predict_fixture
    out = predict.main(_predict_args(root, root / "tiles", root / "probs_torch", checkpoint))
    assert out["tiles"] == 2
    jax_predict.main(_predict_args(root, root / "tiles", root / "probs_jax", checkpoint))
    pngs = sorted(p.relative_to(root / "probs_jax") for p in (root / "probs_jax").rglob("*.png"))
    assert len(pngs) == 2
    for rel in pngs:
        ref_img, got_img = Image.open(root / "probs_jax" / rel), Image.open(root / "probs_torch" / rel)
        assert got_img.mode == "P" and got_img.size == (64, 64)
        assert got_img.getpalette() == ref_img.getpalette()
        _assert_close_bins(np.asarray(got_img), np.asarray(ref_img))


@pytest.mark.parametrize(
    "common,tolerance",
    [({"int8": True, "pallas_tail": "sep"}, None), ({"int8": False, "bf16": True}, 0.99),
     ({"int8": True, "fused_head": False}, "bins"), ({"int8": False, "fused_head": False}, "bins"),
     ({"int8": False, "bf16": True, "fused_head": False}, 0.99)],
    ids=["sep", "bf16", "int8-unfused", "fp32-unfused", "bf16-unfused"],
)
def test_predict_tool_model_keys_match_jax(tmp_path, predict_fixture, common, tolerance):
    """`rs predict` through a `pallas_tail = "sep"` TOML (the doubly-blocked
    output, peeled once by the writer), an `int8 = false` TOML (the bf16
    float predict) and `fused_head = false` TOMLs (fine input and output)
    against the JAX tool: the "sep" PNGs equal, the int8 and float32
    unfused ones within one bin on at most 0.1% of the pixels (measured on
    the CPU: equal), the bf16 ones within one bin on >= 99% of pixels."""
    from robosat_tpu.tools import predict as jax_predict
    from robosat_tpu_torch.tools import predict

    root, _, checkpoint = predict_fixture
    save_config({"common": {"cuda": False, "batch_size": 2, "image_size": 64, "checkpoint": str(root), **common}},
                str(tmp_path / "model.toml"))
    save_config({"common": {"dataset": str(root), "classes": ["background", "parking"],
                            "colors": ["denim", "orange"]}}, str(tmp_path / "dataset.toml"))
    assert predict.main(_predict_args(tmp_path, root / "tiles", tmp_path / "probs_torch", checkpoint))["tiles"] == 2
    jax_predict.main(_predict_args(tmp_path, root / "tiles", tmp_path / "probs_jax", checkpoint))
    pngs = sorted(p.relative_to(tmp_path / "probs_jax") for p in (tmp_path / "probs_jax").rglob("*.png"))
    assert len(pngs) == 2
    for rel in pngs:
        ref_img, got_img = Image.open(tmp_path / "probs_jax" / rel), Image.open(tmp_path / "probs_torch" / rel)
        assert got_img.mode == "P" and got_img.size == (64, 64)
        assert got_img.getpalette() == ref_img.getpalette()
        d = _bin_distance(np.asarray(got_img), np.asarray(ref_img))
        print("{}: {} of {} pixels differ, max distance {}".format(rel, int((d != 0).sum()), d.size, d.max()))
        if tolerance is None:
            assert int((d != 0).sum()) == 0
        elif tolerance == "bins":
            _assert_close_bins(np.asarray(got_img), np.asarray(ref_img))
        else:
            assert (d <= 1).mean() >= tolerance


@pytest.mark.parametrize(
    "common,overrides,tolerance",
    [({"int8": True}, {"strip": 3}, None), ({"int8": False}, {"strip": 3}, None),
     ({"int8": False, "bf16": True}, {"strip": 3}, 0.99), ({"int8": True, "host_s2d": False}, {}, None),
     ({"int8": True}, {"tile_size": 62, "overlap": 1}, None), ({"int8": False}, {"tile_size": 62, "overlap": 1}, None)],
    ids=["int8-strip", "fp32-strip", "bf16-strip", "int8-fine", "int8-odd", "fp32-odd"],
)
def test_predict_tool_modes_match_jax(tmp_path, predict_fixture, common, overrides, tolerance):
    """`rs predict` with `--strip 3` (the fixture's two tiles as one strip
    of a column, fine input and output), with `host_s2d = false`, and with
    an odd overlap (`--tile_size 62 --overlap 1`: fine output from the
    fused head) against the JAX tool on the same checkpoint and
    `qat_amaxes`: int8 and fp32 PNGs equal, bf16 ones within one bin on
    >= 99% of pixels."""
    from robosat_tpu.tools import predict as jax_predict
    from robosat_tpu_torch.tools import predict

    root, _, checkpoint = predict_fixture
    size = overrides.get("tile_size", 64)
    save_config({"common": {"cuda": False, "batch_size": 2, "image_size": 64, "checkpoint": str(root), **common}},
                str(tmp_path / "model.toml"))
    save_config({"common": {"dataset": str(root), "classes": ["background", "parking"],
                            "colors": ["denim", "orange"]}}, str(tmp_path / "dataset.toml"))
    out = predict.main(_predict_args(tmp_path, root / "tiles", tmp_path / "probs_torch", checkpoint, **overrides))
    assert out["tiles"] == 2
    jax_predict.main(_predict_args(tmp_path, root / "tiles", tmp_path / "probs_jax", checkpoint, **overrides))
    pngs = sorted(p.relative_to(tmp_path / "probs_jax") for p in (tmp_path / "probs_jax").rglob("*.png"))
    assert len(pngs) == 2
    for rel in pngs:
        ref_img, got_img = Image.open(tmp_path / "probs_jax" / rel), Image.open(tmp_path / "probs_torch" / rel)
        assert got_img.mode == "P" and got_img.size == ref_img.size == (size, size)
        assert got_img.getpalette() == ref_img.getpalette()
        d = _bin_distance(np.asarray(got_img), np.asarray(ref_img))
        print("{}: {} of {} pixels differ, max distance {}".format(rel, int((d != 0).sum()), d.size, d.max()))
        if tolerance is None:
            assert int((d != 0).sum()) == 0
        else:
            assert (d <= 1).mean() >= tolerance


@pytest.fixture(scope="module")
def column_tiles(tmp_path_factory):
    """Two columns of 64-px tiles with a gap in y (strips of 3 split into
    runs and chunks), as in tests/test_strip_predict.py."""
    root = tmp_path_factory.mktemp("port_strips")
    rng = np.random.default_rng(0)
    for x, y in [(100, y) for y in (50, 51, 52, 53, 55)] + [(101, 50), (101, 51)]:
        d = root / "18" / str(x)
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 255, (64, 64, 3), np.uint8)).save(d / "{}.png".format(y))
    return root


def test_predict_tool_strip_equals_per_tile(tmp_path, predict_fixture, column_tiles):
    """The port's `--strip 3` PNGs equal its per-tile ones in float32 (the
    strips carry the same context and the convolutions are translation
    invariant), over seven tiles in five strips."""
    from robosat_tpu_torch.tools import predict

    _, checkpoint, _ = predict_fixture
    save_config({"common": {"cuda": False, "int8": False}}, str(tmp_path / "model.toml"))
    save_config({"common": {"classes": ["background", "parking"]}}, str(tmp_path / "dataset.toml"))
    for strip in (1, 3):
        out = predict.main(_predict_args(tmp_path, column_tiles, tmp_path / "probs{}".format(strip), checkpoint,
                                         overlap=32, strip=strip, batch_size=4))
        assert out["tiles"] == 7
    singles = sorted(p.relative_to(tmp_path / "probs1") for p in (tmp_path / "probs1").rglob("*.png"))
    assert len(singles) == 7
    for rel in singles:
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "probs3" / rel)),
                                      np.asarray(Image.open(tmp_path / "probs1" / rel)), err_msg=str(rel))


def test_predict_tool_profile_writes_trace(tmp_path, predict_fixture):
    """`--profile DIR` on the CPU: a TensorBoard trace in DIR whose events
    hold one `predict_batch` range per batch."""
    import json

    from robosat_tpu_torch.tools import predict

    root, checkpoint, _ = predict_fixture
    save_config({"common": {"cuda": False, "int8": True}}, str(tmp_path / "model.toml"))
    save_config({"common": {"classes": ["background", "parking"]}}, str(tmp_path / "dataset.toml"))
    trace_dir = tmp_path / "trace"
    out = predict.main(_predict_args(tmp_path, root / "tiles", tmp_path / "probs", checkpoint, batch_size=1,
                                     profile=str(trace_dir)))
    assert out["tiles"] == 2
    traces = list(trace_dir.glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert sum(e.get("name") == "predict_batch" and e.get("cat") == "user_annotation" for e in events) == 2


@pytest.mark.parametrize(
    "common,overrides,error",
    [({"model": "segformer", "int8_calibration": "pc99.8"}, {}, ValueError),
     ({"int8_calibration": "pcx"}, {}, ValueError)],
    ids=["segformer", "pc-bad-spec"],
)
def test_predict_tool_unported_modes_raise(tmp_path, predict_fixture, common, overrides, error):
    """The per-channel calibrations with a model whose quantizer takes no
    per-channel amaxes (SegFormer) raise the JAX package's ValueError
    before anything is written; a "pc<percentile>" spec whose percentile is
    no number fails when the config is read, with the JAX tool's
    ValueError."""
    from robosat_tpu_torch.tools import predict

    root, checkpoint, _ = predict_fixture
    save_config({"common": {"cuda": False, "int8": True, **common}}, str(tmp_path / "model.toml"))
    save_config({"common": {"classes": ["background", "parking"]}}, str(tmp_path / "dataset.toml"))
    with pytest.raises(error, match="does not support per-channel|pcx|float"):
        predict.main(_predict_args(tmp_path, root / "tiles", tmp_path / "probs", checkpoint, **overrides))
    assert not (tmp_path / "probs").exists()


def test_dispatch_ahead_issues_before_fetching():
    """The tool's loop with a counting step: the first batch is done before
    the second is issued (the steady clock's start), batch k + 1 is issued
    before batch k is fetched, at most three batches are pending, and each
    batch reaches the writer once, with its own output."""
    from robosat_tpu_torch.tools import predict

    log = []

    class Handle:
        def __init__(self, k):
            self.k = k

        def fetch(self):
            log.append(("fetch", self.k))
            return self.k

    def issue(k):
        log.append(("issue", k))
        return Handle(k)

    written = []
    n = 6
    assert predict.dispatch_ahead(range(n), issue, lambda k, out: written.append((k, out))) is not None
    assert written == [(k, k) for k in range(n)]
    assert log[:3] == [("issue", 0), ("fetch", 0), ("issue", 1)]
    order = log[:1] + log[2:]  # without the first batch's set-up wait
    for k in range(n - 1):
        assert order.index(("issue", k + 1)) < order.index(("fetch", k))
    pending = 0
    for event, _ in order:
        pending += 1 if event == "issue" else -1
        assert 0 <= pending <= predict.IN_FLIGHT + 1 == 3
    assert predict.dispatch_ahead([], issue, None) is None


def test_predict_tool_counting_step_writes_each_png_once(tmp_path, predict_fixture, monkeypatch):
    """`predict.main` over six tiles, one per batch, with a counting step in
    place of the int8 step: every step's output is fetched through the
    tool's handle after the next batch was issued, and each tile's PNG is
    written once, with its own batch's values."""
    from robosat_tpu_torch.native import imagecodec
    from robosat_tpu_torch.tools import predict

    root, checkpoint, _ = predict_fixture
    rng = np.random.default_rng(13)
    tiles = [(69623 + i // 3, 104945 + i % 3) for i in range(6)]
    for x, y in tiles:
        (tmp_path / "tiles" / "18" / str(x)).mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)).save(
            tmp_path / "tiles" / "18" / str(x) / "{}.png".format(y))
    save_config({"common": {"cuda": False, "int8": True}}, str(tmp_path / "model.toml"))
    save_config({"common": {"classes": ["background", "parking"]}}, str(tmp_path / "dataset.toml"))

    log = []

    def counting_step(_, raw):
        k = sum(event == "issue" for event, _ in log)
        log.append(("issue", k))
        assert raw.shape == (1, 16, 16, 48)
        return torch.full((1, 32, 32, 4), 10 * k, dtype=torch.uint8)

    class Counted(predict.Dispatched):
        def fetch(self):
            out = super().fetch()
            log.append(("fetch", int(out.flat[0]) // 10))
            return out

    paths = []
    encode = imagecodec.encode_palette_png_d2s

    def counting_encode(path, *args):
        paths.append(path)
        return encode(path, *args)

    monkeypatch.setattr(predict, "make_int8_predict_step", lambda *a, **k: (counting_step, None))
    monkeypatch.setattr(predict, "Dispatched", Counted)
    monkeypatch.setattr(imagecodec, "encode_palette_png_d2s", counting_encode)
    out = predict.main(_predict_args(tmp_path, tmp_path / "tiles", tmp_path / "probs", checkpoint, batch_size=1))
    assert out["tiles"] == 6
    issued = [k for event, k in log if event == "issue"]
    assert issued == list(range(6))
    for k in range(5):
        last_fetch = max(i for i, e in enumerate(log) if e == ("fetch", k))
        assert log.index(("issue", k + 1)) < last_fetch
    assert sorted(paths) == sorted(set(paths)) and len(paths) == 6
    values = sorted(int(np.unique(np.asarray(Image.open(path)))[0]) for path in paths)
    assert values == [10 * k for k in range(6)]
    assert all(np.unique(np.asarray(Image.open(path))).size == 1 for path in paths)
