"""robosat_tpu_torch's `export` vs the JAX package's, on the CPU.

One npz (the JAX package's full-width `unet.init(0)`, BN var + eps == 1 so
that the fold is exact in both packages) goes through both tools:

- `--format onnx`: the same bytes, and the JAX tool's two refusals with
  its messages;
- `--format pt2 --graph logits`: the reloaded program equals the port's
  eager `apply` bit for bit, and the JAX package's `apply` within
  tests/test_export.py's bound (rtol 1e-3, atol 1e-2);
- `--format pt2 --graph predict`: the reloaded program equals the port's
  eager step bit for bit, holds the margin head as one
  `robosat.margin_head` node, and is held to tests/test_export.py's bound
  against the JAX step (>= 99% of pixels within one bin, mean under 1);
- `fast`, `deeplabv3plus` and `segformer` export both graphs in this
  process, after the U-Net's, then run an eager step: a device constant
  cached while tracing (ops/augment.py, ops/quantize.py) would fail the
  next trace or the eager step;
- `torch.ops.robosat.margin_head` on the CPU is the plain head for G = 1,
  4 and 16, and `--format stablehlo` exits naming `pt2`.
"""

import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robosat_tpu.checkpoint import save_checkpoint
from robosat_tpu.config import save_config
from robosat_tpu.models.registry import get_model as jax_get_model
from robosat_tpu.parallel.steps import make_predict_step as jax_make_predict_step
from robosat_tpu.tools import export as jexport
from robosat_tpu_torch.checkpoint import from_jax
from robosat_tpu_torch.models.registry import get_model
from robosat_tpu_torch.ops import head
from robosat_tpu_torch.parallel.steps import make_predict_step
from robosat_tpu_torch.tools import export

SIZE = 64
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """Two intra-op threads while this module traces and runs full-width
    models on the CPU: tier-1 runs six xdist workers, and a full OpenMP pool
    in each oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _exact_var(tree):
    """The tree with every BN `var` at 1 - 1e-5 in float32 (var + eps == 1)."""
    if isinstance(tree, dict):
        return {k: (np.full_like(v, np.float32(1.0) - np.float32(1e-5)) if k == "var" else _exact_var(v))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_exact_var(v) for v in tree)
    return np.asarray(tree)


def _weights(family):
    params, state = jax_get_model(family).init(0, num_classes=2)
    return jax.tree_util.tree_map(np.asarray, params), _exact_var(state)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{family: npz} for the four families and the dataset TOML."""
    root = tmp_path_factory.mktemp("export")
    dataset = str(root / "dataset.toml")
    save_config({"common": {"dataset": str(root), "classes": ["background", "parking"],
                            "colors": ["denim", "orange"]}}, dataset)
    ckpts = {}
    for family in ("unet", "fast", "deeplabv3plus", "segformer"):
        params, state = _weights(family)
        ckpts[family] = str(root / (family + ".npz"))
        save_checkpoint(ckpts[family], {"params": params, "state": state}, {"epoch": 1})
    return ckpts, dataset


def _args(files, out, family="unet", **flags):
    ckpts, dataset = files
    args = dict(dataset=dataset, image_size=SIZE, checkpoint=ckpts[family], batch_size=1, graph="logits",
                family=family, format="pt2", model=str(out))
    args.update(flags)
    return argparse.Namespace(**args)


def _raw(seed, n=1):
    return np.random.default_rng(seed).integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8)


def _reload(path):
    """The saved program, its file deleted (each is ~150 MB)."""
    program = torch.export.load(str(path))
    os.remove(str(path))
    return program


def _margin_nodes(program):
    return [n for n in program.graph.nodes if n.op == "call_function" and "robosat.margin_head" in str(n.target)]


def test_onnx_bytes_equal_jax(files, tmp_path, capsys):
    export.main(_args(files, tmp_path / "p.onnx", format="onnx", batch_size=2))
    printed = capsys.readouterr().out
    jexport.main(_args(files, tmp_path / "j.onnx", format="onnx", batch_size=2))
    got, want = (tmp_path / "p.onnx").read_bytes(), (tmp_path / "j.onnx").read_bytes()
    for path in (tmp_path / "p.onnx", tmp_path / "j.onnx"):  # ~150 MB each
        path.unlink()
    assert got == want
    assert printed.strip() == "Exported ONNX ({} bytes) to {}".format(len(got), tmp_path / "p.onnx")


@pytest.mark.parametrize("flags", [{"family": "segformer"}, {"graph": "predict"}], ids=["family", "graph"])
def test_onnx_refusals_match_jax(files, tmp_path, flags):
    with pytest.raises(SystemExit) as want:
        jexport.main(_args(files, tmp_path / "j.onnx", format="onnx", **flags))
    with pytest.raises(SystemExit) as got:
        export.main(_args(files, tmp_path / "p.onnx", format="onnx", **flags), device=CPU)
    assert str(got.value) == str(want.value) and str(got.value).startswith("Error: --format onnx")
    assert not (tmp_path / "p.onnx").exists()


def test_stablehlo_exits_naming_pt2(files, tmp_path):
    with pytest.raises(SystemExit) as got:
        export.main(_args(files, tmp_path / "m.stablehlo", format="stablehlo"), device=CPU)
    assert "stablehlo" in str(got.value) and "pt2" in str(got.value)
    parser = argparse.ArgumentParser()
    export.add_parser(parser.add_subparsers())
    with pytest.raises(SystemExit):
        parser.parse_args(["export", "--dataset", "d", "--checkpoint", "c", "--format", "stablehlo", "m"])
    assert parser.parse_args(["export", "--dataset", "d", "--checkpoint", "c", "m"]).format == "pt2"


def test_parser_takes_the_jax_tools_flags():
    """The JAX tool's flags and defaults, but for --format (pt2 here)."""
    def parse(tool):
        parser = argparse.ArgumentParser()
        tool.add_parser(parser.add_subparsers())
        return vars(parser.parse_args(["export", "--dataset", "d", "--checkpoint", "c", "--graph", "predict",
                                       "--family", "fast", "--batch_size", "4", "m"]))

    got, want = parse(export), parse(jexport)
    assert (got.pop("format"), want.pop("format")) == ("pt2", "stablehlo")
    assert {k: v for k, v in got.items() if k != "func"} == {k: v for k, v in want.items() if k != "func"}


def test_logits_pt2_reloads_equal_to_eager_apply(files, tmp_path, capsys):
    out = tmp_path / "logits.pt2"
    export.main(_args(files, out), device=CPU)
    assert "Exported pt2 ({} bytes) to {}".format(os.path.getsize(out), out) in capsys.readouterr().out
    program = _reload(out)
    assert "params.encoder.conv1.w" in program.state_dict and not program.constants
    x = np.random.default_rng(0).normal(size=(1, SIZE, SIZE, 3)).astype(np.float32)
    got = program.module()(torch.from_numpy(x))
    params, state = _weights("unet")
    tp, ts = from_jax(params, state)
    with torch.no_grad():
        eager, _ = get_model("unet").apply(tp, ts, torch.from_numpy(x), train=False)
    assert torch.equal(got, eager)
    want, _ = jax.jit(lambda p, s, v: jax_get_model("unet").apply(p, s, v, train=False))(params, state, x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-2)


def test_unet_predict_pt2_keeps_k1_and_equals_eager_step(files, tmp_path):
    out = tmp_path / "predict.pt2"
    export.main(_args(files, out, graph="predict", batch_size=2), device=CPU)
    program = _reload(out)
    nodes = _margin_nodes(program)
    assert len(nodes) == 1 and nodes[0].args[3:] == (0, 4)  # K1 on the parity-blocked grid
    assert "folded.encoder.conv1.b" in program.state_dict  # folded weights, no fold in the graph
    raw = _raw(1, 2)
    got = program.module()(torch.from_numpy(raw))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (2, SIZE, SIZE)
    params, state = _weights("unet")
    tp, ts = from_jax(params, state)
    step = make_predict_step(get_model("unet"), overlap=0, compute_dtype=torch.bfloat16, fused_head=True)
    assert torch.equal(got, step(tp, ts, raw))
    expected = np.asarray(jax_make_predict_step(jax_get_model("unet"), overlap=0, compute_dtype=jnp.bfloat16,
                                                fused_head=True)(params, state, raw))
    d = np.abs(got.numpy().astype(np.int32) - expected.astype(np.int32))
    d = np.minimum(d, 256 - d)
    print("within one bin: {:.4%}, mean distance {:.4f}".format((d <= 1).mean(), d.mean()))
    assert (d <= 1).mean() > 0.99
    assert d.mean() < 1.0


@pytest.mark.parametrize("graph", ["predict", "logits"])
@pytest.mark.parametrize("family", ["fast", "deeplabv3plus", "segformer"])
def test_family_exports_both_graphs_in_one_process(files, tmp_path, family, graph):
    """Each graph of each family, in this process after the U-Net's:
    reloaded and run against the eager forward, then an eager step. The
    fast family's head runs in torch ops, so its program holds no
    robosat.margin_head node, nor do DeepLab's and SegFormer's
    margin-then-resize heads."""
    params, state = _weights(family)
    tp, ts = from_jax(params, state)
    model = get_model(family)
    raw = _raw(2)
    step = make_predict_step(model, overlap=0, compute_dtype=torch.bfloat16, fused_head=True)
    out = tmp_path / "{}.pt2".format(graph)
    export.main(_args(files, out, family=family, graph=graph), device=CPU)
    program = _reload(out)
    assert not _margin_nodes(program)
    if graph == "predict":
        assert torch.equal(program.module()(torch.from_numpy(raw)), step(tp, ts, raw))
    else:
        x = torch.from_numpy(np.random.default_rng(3).normal(size=(1, SIZE, SIZE, 3)).astype(np.float32))
        with torch.no_grad():
            eager, _ = model.apply(tp, ts, x, train=False)
        assert torch.equal(program.module()(x), eager)
    eager = step(tp, ts, raw)
    assert eager.dtype == torch.uint8 and tuple(eager.shape) == (1, SIZE, SIZE)


@pytest.mark.parametrize("groups", [1, 4, 16])
def test_margin_head_op_on_the_cpu_is_the_plain_head(groups):
    gen = torch.Generator().manual_seed(groups)
    w, b = torch.randn(1, 1, 32, 2, generator=gen), torch.randn(2, generator=gen)
    overlap = 8
    for dtype in (torch.float32, torch.bfloat16):
        feats = torch.randn(2, 20, 24, 32 * groups, generator=gen).relu().to(dtype)
        got = torch.ops.robosat.margin_head(feats, w, b, overlap, groups)
        assert torch.equal(got, head.margin_head_plain(feats, w, b, overlap, groups))
        assert torch.equal(head.margin_head(feats, w, b, overlap, groups), got)
