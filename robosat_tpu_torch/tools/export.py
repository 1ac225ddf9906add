"""`rs export` — serialize the model for deployment.

Counterpart of robosat_tpu/tools/export.py, with its flags but for
`--format`: the JAX tool writes StableHLO (jax.export), which the port
cannot write without JAX; its counterpart here is `pt2`, a torch.export
program saved by `torch.export.save`, which `torch.export.load` reloads
and `.module()` runs. The program holds its weights as buffers under their
tree's names (`params.encoder.conv1.w`, `folded.dec5.w`, ...):

- `--graph logits`: float NHWC in -> logits, `model.apply` in eval mode
  over the params and the BN state as the checkpoint holds them;
- `--graph predict`: uint8 tiles in -> quantized probability uint8 out,
  `make_predict_step(model, overlap=0, compute_dtype=bfloat16,
  fused_head=True)` over the tree folded once before tracing, so that the
  program runs no fold. For the U-Net the margin head stays one node,
  `robosat.margin_head` (kernel K1 on the card): loading such a program
  needs `import robosat_tpu_torch.ops.head` first.

The program is traced on the device `main` is given (the card when None),
and runs there. `--format onnx` writes the BN-folded U-Net's logits graph
as a plain ONNX ModelProto (utils/onnx.py, the JAX package's bytes) on the
host, with the JAX tool's two refusals.
"""

import argparse
import os
import sys

import torch

from robosat_tpu_torch.checkpoint import load_model_checkpoint, to_jax
from robosat_tpu_torch.config import load_config
from robosat_tpu_torch.device import configure_device
from robosat_tpu_torch.models.registry import get_model

STABLEHLO_REFUSAL = ("Error: --format stablehlo needs jax, which the port does not use; "
                     "write --format pt2 (a torch.export program) or onnx")


def add_parser(subparser):
    parser = subparser.add_parser(
        "export", help="exports model as a torch.export program or ONNX",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter
    )

    parser.add_argument("--dataset", type=str, required=True, help="path to dataset configuration file")
    parser.add_argument("--image_size", type=int, default=512, help="image size to use for model")
    parser.add_argument("--checkpoint", type=str, required=True, help="model checkpoint to load")
    parser.add_argument("--batch_size", type=int, default=1, help="batch size baked into the export")
    parser.add_argument(
        "--graph",
        type=str,
        default="logits",
        choices=("logits", "predict"),
        help="logits: raw forward (float NHWC in -> logits); predict: the "
        "deployed fast path (uint8 tiles in -> quantized prob uint8 out, "
        "BN folded, fused margin head)",
    )
    parser.add_argument(
        "--family",
        type=str,
        default="unet",
        help="model family to export (registry name: unet, fast, deeplabv3plus, segformer)",
    )
    parser.add_argument(
        "--format",
        type=str,
        default="pt2",
        choices=("pt2", "onnx"),
        help="pt2: torch.export program (any graph/family; a predict program needs "
        "`import robosat_tpu_torch.ops.head` before torch.export.load); onnx: plain "
        "ONNX ModelProto of the BN-folded logits graph (unet only)",
    )
    parser.add_argument("model", type=str, help="path to save the exported model to")

    parser.set_defaults(func=main)


class _Tree(torch.nn.Module):
    """A tree of dicts, lists and tuples of tensors as nested modules whose
    buffers carry the tree's keys, so that a traced program names its
    weights by their path in the tree."""

    def __init__(self, tree):
        super().__init__()
        self._kind = type(tree)
        items = list(tree.items() if isinstance(tree, dict) else enumerate(tree))
        self._keys = [key for key, _ in items]
        for key, value in items:
            if torch.is_tensor(value):
                self.register_buffer(str(key), value)
            else:
                self.add_module(str(key), _Tree(value))

    def rebuild(self):
        values = [getattr(self, str(key)) for key in self._keys]
        values = [v.rebuild() if isinstance(v, _Tree) else v for v in values]
        return dict(zip(self._keys, values)) if self._kind is dict else self._kind(values)


class _Program(_Tree):
    """forward(x) = fn(trees, x), `trees` held as the buffers of `_Tree`."""

    def __init__(self, trees, fn):
        super().__init__(trees)
        self._fn = fn

    def forward(self, x):
        return self._fn(self.rebuild(), x)


def program(model, params, state, graph, batch_size, image_size, device):
    """The torch.export program of `graph` ("logits" or "predict") for
    `model` over (params, state) on `device`, traced at a static input
    shape (batch_size, image_size, image_size, 3)."""
    shape = (batch_size, image_size, image_size, 3)
    if graph == "predict":
        from robosat_tpu_torch.parallel.steps import make_predict_step

        step = make_predict_step(model, overlap=0, compute_dtype=torch.bfloat16, fused_head=True)
        with torch.no_grad():
            trees = {"folded": model.fold(params, state)}

        def fn(t, x):
            return step.folded(t["folded"], x)

        example = torch.zeros(shape, dtype=torch.uint8, device=device)
    else:
        trees = {"params": params, "state": state}

        def fn(t, x):
            logits, _ = model.apply(t["params"], t["state"], x, train=False)
            return logits

        example = torch.zeros(shape, dtype=torch.float32, device=device)
    with torch.no_grad():
        return torch.export.export(_Program(trees, fn), (example,))


def main(args, device=None):
    """Run the tool; `device` is where a pt2 program is traced and runs,
    the card when None (raising without one)."""
    fmt = getattr(args, "format", "pt2")
    if fmt == "stablehlo":
        sys.exit(STABLEHLO_REFUSAL)
    family = getattr(args, "family", "unet")
    graph = getattr(args, "graph", "logits")
    dataset = load_config(args.dataset)
    num_classes = len(dataset["common"]["classes"])
    model = get_model(family)

    if fmt == "onnx":
        from robosat_tpu_torch.utils.onnx import export_unet_onnx

        if family != "unet":
            sys.exit("Error: --format onnx supports the unet family (use stablehlo for others)")
        if graph != "logits":
            sys.exit("Error: --format onnx exports the logits graph (the fast path is StableHLO-only)")
        params, state, _ = load_model_checkpoint(args.checkpoint, num_classes)
        with torch.no_grad():
            folded = to_jax(model.fold(params, state))
        data = export_unet_onnx(folded, num_classes, image_size=args.image_size, batch_size=args.batch_size)
        with open(args.model, "wb") as fp:
            fp.write(data)
        print("Exported ONNX ({} bytes) to {}".format(len(data), args.model))
        return

    if device is None:
        device = configure_device(True)
    params, state, _ = load_model_checkpoint(args.checkpoint, num_classes, device=device)
    exported = program(model, params, state, graph, args.batch_size, args.image_size, device)
    torch.export.save(exported, args.model)
    print("Exported pt2 ({} bytes) to {}; torch.export.load reloads it (a predict program after "
          "`import robosat_tpu_torch.ops.head`)".format(os.path.getsize(args.model), args.model))
