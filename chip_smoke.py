#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            (from the repository root; one GPU)

Drives robosat_tpu_torch's `predict` (the U-Net of config/model-unet.toml)
on the card along nine paths and its `masks`, runs the two probe kernels,
checks each hand-written kernel against its plain PyTorch version, and
trains the U-Net (`train`, then `predict` from what it wrote), also
quantization-aware and by distillation; then the fast family
(config/model-fast.toml) the same way, the README's workflow from an OSM
extract to GeoJSON, DeepLabv3+ (`model = "deeplabv3plus"`), SegFormer, the
per-channel calibration, and last the multi-device layer:

1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
2. build of the CUDA kernels from robosat_tpu_torch/csrc;
3. each kernel against its plain version at main-path shapes (batch 8 at
   576 px buffered tiles, weights and scales of the calibrated model):
   K3 at one block of every stage (layer1.0 with its projection, layer1.1,
   layer2.1, layer3.1, layer4.1), K4 at the first block of layers 2-4, K5
   at its five up-blocks (center, dec0-dec3), K7/K8/K9, bit-equal in bf16,
   the uint8 of K6 and of K1 (G = 1, 4 and 16 groups, f32 and bf16
   features) equal up to counted +-1-bin flips; K3 (layer1.0, layer4.1),
   K4 (layer2.0), K5 (center, dec3), K6 (overlap 0) and K1 (G = 4, bf16)
   also at the shapes of a --strip 8 batch (one 4160 x 576 image); K6, K7
   and K9 with their counts of skipped weight blocks; kernel and plain times from CUDA events with the
   inputs rotated through copies larger than the 50 MB L2 (as in phase 4),
   and beside each kernel time its device-only time from torch.profiler's
   kernel rows and its TOP/s against the 1,979 TOP/s int8 peak;
4. the probes path: K2 (int8 matmul + requantize) in both orientations at
   the 8 contractions of benchmarks/bench_pallas_mm.py, bit-equal to its
   plain version, its int32 accumulators equal to `torch._int_mm`'s; K10's
   12 head-stage rungs at the bisect script's (1, 8, 288, 128) and at a full
   dec5 batch (8, 288, 288, 128), against the plain rungs (bit-equal up to
   the margins, the sigmoid within 4 ulps, uint8 up to counted +-1 flips);
   launches counted over one pass (K2 16, K10 24, every other kernel 0),
   kernel, plain and `_int_mm` times from CUDA events, and K2's device-only
   time from torch.profiler with its GB/s, TOP/s and share of its bound;
5. `predict.main` in-process on a generated 8 x 8 block of 512-px tiles
   with a random-weight full-width U-Net checkpoint, once per path of
   PATHS, each through a TOML copy in a temp dir: int8 as configured;
   `pallas_tail = "tail"`; `"sep"`; `fused_head = false` (fine input);
   `int8 = false`, bf16; `host_s2d = false` (fine input, K6 at overlap 0,
   fine output); `--strip 8` (one 4160 x 576 strip a batch); `--tile_size
   510 --overlap 33` (an odd overlap: K6 at overlap 0, fine 510-px PNGs);
   bf16 with `--strip 8`. Every int8 path but the first reads phase 3's
   scales from a QAT checkpoint's qat_amaxes (the first calibrates to the
   same scales), and every int8 path's first-batch check takes them: each
   calibration of the full U-Net takes ~10 s of the card. Per path: one decodable palette PNG
   per tile; each kernel's launch counter per batch (PATHS: 13 K3, 3 K4 and
   5 K5 with 1 K6 on every int8 path with the fused head, 1 K7 and 1 K1 on
   "tail", 4 K5 with 1 K8, 1 K9 and 1 K1 on "sep", 1 K7 unfused; 1 K1 on
   the bf16 paths; 0 for every other kernel); the "tail" and "sep" PNGs
   against the int8 run's up to counted +-1 flips (other pairs, COMPARED,
   only counted: NOT_HELD says why); the first batch's uint8 against the
   plain path with the same weights and scales, and equal to the PNGs
   predict wrote for it; and a torch.profiler split of one step's device
   time: the int8 convs summed (it fails if one runs outside
   csrc/int8_conv_sm90.cuh's rs::sm90 kernels) and, by kernel name,
   tail_kernel (K6, K7, K9), up_kernel (K5 storing NHWC, K8 parity planes;
   it fails unless the launches are the path's K5 + K8) and K4's blocks
   (each stride-2 conv2 with the conv launched before it and the two after
   it). Then the int8 path once more under `--profile` (its launches
   counted again; the trace must hold a predict_batch range per batch and
   conv_kernel and tail_kernel rows; its PNGs equal the int8 run's), and
   `masks` over the int8 run's PNGs, each mask equal to
   softvote(_load_probs(png)) recomputed on the host.

6. `train` (no kernel of the port runs in training; cuDNN convolutions,
   torch.sort and plain tensor ops stand where the JAX package leaves
   XLA): 6a, the float32 train step (TF32 off) at 64 px, batch 2,
   augmentation off, 3 steps with CrossEntropy (dataset-parking's weights)
   and 3 with Lovasz on the card and on the CPU in this process, from the
   same weights: step-0 loss within 1e-4 relative, the gradient cosines of
   tests/test_torch_train_parity.py's five leaves at or above its floors,
   steps 1-2 within 5%, bn1's running statistics within 5e-3; 6b,
   config/model-unet.toml's step as it stands (bf16, Lovasz, batch 64 at
   512 px, remat off, augmentation on, `unet.init`) for 10 steps on one
   learnable batch: each step's loss (finite, step 10's below step 1's),
   the median step by CUDA events over steps 3-10 and images/s,
   `torch.cuda.max_memory_allocated`, the device idle share and the 8
   costliest kernels from torch.profiler over 3 steps, and 4 steps with
   cuDNN's nondeterministic algorithms for comparison (with remat = true
   instead, said so, if batch 64 does not fit); 6c, `train.main` on 64
   training and 16 validation tiles of 512 px (a TOML copy with batch 16):
   epoch 1, then `--resume` to epoch 2 (the restored count equal to the
   steps taken), the log's lines and both checkpoints, then int8 `predict`
   from `checkpoint-00002-of-00002.npz` over the training tiles, one PNG a
   tile and 13 K3, 3 K4, 5 K5 and 1 K6 launches a batch.

7. QAT and distillation (`train --qat`, `train --teacher`; the fake-quant
   walk runs torch ops, its int8 counterpart the kernels): 7a, the QAT
   step (Lovasz) and the distillation step (CrossEntropy, alpha 0.9, T 2)
   in float32 at 64 px, batch 2, 3 steps each on the card and on the CPU
   from the same weights, every card step equal to its Adam replayed on
   the CPU; each QAT step on the card quantizes the CPU step's site inputs
   (free, the forwards part at flipped bins): step 0's site inputs within
   1e-5, its loss 1e-4, 6a's gradient cosine floors, steps 1-2 within
   1e-3, the BN state unchanged bit for bit; distillation held as 6a;
   7b, the configured steps (bf16, Lovasz, batch 64 at 512 px,
   augmentation on) for 10 steps each, QAT from 6b's trained weights with
   scales calibrated on the batch, distillation of `unet.init` by 6b's
   weights: median step by CUDA events over steps 3-10, images/s, peak
   memory, idle share and kernels by kind; then the QAT contract on 8 of
   the batch's images: the bf16 fake-quant logits against the int8 logits
   of K3/K4/K5, K7, the depth-to-space and the final 1x1 conv (13 K3, 3
   K4, 5 K5, 1 K7 launches) within QAT_CONTRACT; 7c, `train --qat` and
   `train --teacher` for one epoch each on 6c's dataset from 6c's
   checkpoint, then int8 `predict` from the QAT checkpoint, which must
   quantize with its `qat_amaxes` and calibrate nothing: 64 PNGs, 13 K3,
   3 K4, 5 K5 and 1 K6 launches a batch.

8. The fast family on config/model-fast.toml as it stands, weights from
   `fastnet.init(0)`, in a process of its own (`--fast --fast-from WORK`;
   late in one long process torch.profiler drops kernel events): 8a, the first predict batch (8 host-blocked 576-px
   tiles) through the float32 calibration walk, which keeps each site's
   input; rs_int8_conv (csrc/qconv.cu) at the 12 dense sites, each on the
   route qconv.route names (the nine stride-1 sites on halo_conv_kernel,
   down2/3/4 on conv_kernel), and K5 at u3, u2 and u1 on those inputs,
   bit-equal to their plain versions, timed as phase 3 (events, device
   time, bound); 8b, `predict.main` as configured (int8, host-blocked
   input, 16-channel blocked output: 12 rs_int8_conv launches a batch, 9
   by the halo route and 3 by conv_kernel, and 3 K5) and with `int8 = false` (bf16, fine input,
   no kernel) on phase 5's 64 tiles, with the first batch against the
   plain step, the step by CUDA events and its profile; 8c, the configured
   train, distillation (a folded `unet.init` teacher) and QAT steps, bf16,
   batch 64 at 512 px, 10 steps each (median, peak memory, idle, kernels by
   kind); 8d, `train --teacher` with a U-Net checkpoint (6c's) and
   `--teacher_model config/model-unet.toml` for one epoch, `--resume` to
   two, `--qat` from that checkpoint, then int8 `predict` from the QAT
   checkpoint (its 15 qat_amaxes, no calibration).

10. The README's workflow on robosat_tpu_torch alone, after phase 8, each
   stage a call of the tool's `main` in a temporary directory: a generated
   map over a 6 x 6 block of z18 tiles (40 parking lots, ways the parking
   filter drops, buildings, highways) written as .osm XML and as .osm.pbf;
   `extract` from both (equal parking features; buildings and roads
   non-empty); `cover` (every tile holding a lot's corner listed), plus a
   column of 6 lot-free tiles; generated imagery served by a local
   http.server and fetched by `download`, which needs `requests` (every
   file the served pixels); `rasterize` (foreground where the lots are,
   blank on the lot-free tiles, a second pass byte for byte the first);
   `subset` into training/ and validation/; `weights` (equal to 1/ln(1.02
   + p) recomputed from the labels, then written into the dataset TOML);
   `train` one epoch on the card (config/model-unet.toml, batch cut to 8;
   a checkpoint, finite losses); int8 `predict` on the card over the
   validation tiles (13 K3, 3 K4, 5 K5, 1 K6 a batch, counted as
   `workflow` on the kernels line);
   `masks`, `features`, `merge`, `dedupe` against the extracted lots and
   `compare`, each output valid GeoJSON or PNG; then `serve` (its
   Predictor on the trained checkpoint on the card behind its handler and
   a local upstream over the imagery: 8 z18 tiles, then 16 timed requests,
   each PNG mode P, 512 px, indices <= 1; 4 against the same segment step
   on the CPU, equal but at near-tie pixels, at most 0.1%; the 404 of z17
   and the 500 of a tile the upstream lacks; the median request and the
   step's CUDA-event ms) and `export` (pt2 of the `logits` and `predict`
   graphs at batch 8, traced on the card, and onnx: both programs
   reloaded and run on 8 validation tiles, `logits` against eager
   `unet.apply` within rtol 1e-5, `predict` bit-equal to the eager step,
   its graph holding `robosat.margin_head`, its K1 launches counted as
   `workflow-export`; the program's ms beside the eager step's). One log
   line a stage with its seconds and counts.

11. DeepLabv3+ on a TOML copy of config/model-unet.toml with model =
   "deeplabv3plus" (as tests/test_deeplab.py configures it), weights from
   `deeplab.init(0)`, in a process of its own after phase 10 (`--deeplab
   --deeplab-from WORK`): 11a, the first predict batch (8 host-blocked
   576-px tiles of phase 5) through the float32 calibration walk, which
   keeps each site's input; K3 at layer4.0 (dilation 2, projection) and
   layer4.1 (dilation 2), rs_int8_conv at aspp1, aspp_d0/1/2 (dilations 6,
   12, 18), aspp_proj (`conv_kernel`), dec1 and dec2 (`halo_conv_kernel`),
   each on the route qconv.route names, bit-equal to their plain versions,
   timed as phase 3, each bound counting only the taps inside the grid;
   11b, `predict.main` as configured (int8, host-blocked input: 14 K3, 2
   K4 and 7 rs_int8_conv launches a batch, 5 by conv_kernel and 2 by the
   halo route, counted as `deeplab-int8`) and with `int8 = false` (bf16,
   fine input, no kernel) on phase 5's 64 tiles, the first batch against
   the plain step and the PNGs, the step by CUDA events and its profile;
   11c, the configured train step (bf16, Lovasz, batch 64 at 512 px,
   augmentation on) for 10 steps (median, images/s, peak memory, idle),
   then `train.main` one epoch on 6c's dataset (batch 16) and int8
   `predict` from its checkpoint with the launch counts above.

12. SegFormer (`model = "segformer"`), in a process of its own
   (`--segformer --segformer-from WORK`): its kernels (K2's dequant
   epilogue, the quantize kernel, rs_int8_conv's patch embeds), predict and
   train, as phase 11 runs DeepLab's.

13. The per-channel calibration (int8_calibration = "pc99.8"), in a
   process of its own (`--pc --pc-from WORK`), weights from each family's
   `init(0)`, on phase 5's tiles: 13a, the first predict batch through the
   U-Net's, the fast family's and DeepLab's float32 calibration walks
   (each site's input kept, the seconds of the walk and of the balanced
   fold logged), then the kernels' per-channel instantiations on those
   inputs against their plain versions (bf16 bit-equal; K6's uint8 up to
   counted +-1 flips), timed as phase 3: K3 at layer1.0 and layer3.1, K4
   at layer2.0, K5 at center, dec1 and dec3, K6 dec3 -> head (U-Net);
   rs_int8_conv at b1, down2 and d1 (fast); K3 at layer4.0, dilation 2,
   and rs_int8_conv at aspp_d2, dilation 18 (DeepLab); 13b, `predict.main`
   for the U-Net through a TOML copy with int8_calibration = "pc99.8" on
   the 64 tiles (13 K3, 3 K4, 5 K5, 1 K6 a batch), its first batch against
   the plain step, the step by CUDA events and its profile; 13c, one batch
   of each family's per-channel int8 step against its plain step (the fast
   family's launches, 12 rs_int8_conv and 3 K5, and DeepLab's, 14 K3, 2 K4
   and 7 rs_int8_conv, counted), and its time by CUDA events in turns with
   the per-tensor (amax) step's. Its launches count under the kernels'
   names.

14. The multi-device layer (parallel/mesh.py), in a process of its own
   (`--mesh --mesh-from WORK`), on `unet.init(0)` (its train steps on
   phase 6a's reference-style kernels): 14a, a one-rank NCCL group built
   from RS_*: the configured train step (bf16, batch 64 at 512 px,
   augmentation off, sync_bn) and the same in float32 on 8 rows, 3 steps
   each against the step without a mesh, and the int8 step (amax
   calibration) on phase 5's first batch, bit-equal; two NCCL ranks on the
   one card, which NCCL refuses ("Duplicate GPU detected", printed); 14b,
   two ranks over gloo on the card (`--mesh-rank gloo`, RS_* set): the
   spatial step on one 2048 x 2048 raster, overlap 32, float32, against
   the one-process step (one bin on at most 0.1% of pixels, the flips
   counted, K1 counted on each rank as `spatial`, both steps timed by CUDA
   events) and K1 on each rank's own features against its plain version,
   the configured train step split 32/32 (sync_bn) and each rank the same
   32 rows (no sync_bn) against one process, the float32 step on 8 rows
   split 4/4 (sync_bn, within 1e-4 of 14a's one process; each rank's own
   statistics, the control, outside it), `train.main` one epoch on 6c's
   dataset and int8 `predict.main` on phase 5's 64 tiles (launches
   counted as `mesh-predict`) against one process, and each rank's int8
   step on its 4 rows of predict's first batch against the plain step.
   gloo stages
   CUDA tensors through the host, so 14b's times are of correctness, not
   of NCCL's links.

`python3 chip_smoke.py --k2 [--tree DIR]` runs phases 1-2 and K2's part of
phase 4 only, on the robosat_tpu_torch of checkout DIR (default: this one),
so that two versions of K2 can be timed on one card, one after the other.
`python3 chip_smoke.py --train [--tree DIR]` runs phase 1, 6b and 7b only,
the same way, for two versions of the train steps (7b's contract builds
the kernels at first use). `python3 chip_smoke.py --fast` runs phases 1, 2
and 8 only, with a U-Net checkpoint of `unet.init(0)` and a new dataset in
place of 6c's. `python3 chip_smoke.py --workflow` runs phases 1, 2 and 10
only. `python3 chip_smoke.py --deeplab` runs phases 1, 2 and 11 only,
with a new dataset in place of 6c's; `--segformer` phases 1, 2 and 12;
`--pc` phases 1, 2 and 13; `--mesh` phases 1, 2 and 14.

Each kernel's line also carries its bound: the least time the card could
take for the same work, max(bytes / 3.35 TB/s, operations / peak) with each
input read once and each output written once (int8 ops at 1,979 TOP/s, f32
at 67 TFLOP/s; NVIDIA's H100 SXM data sheet), computed from this run's
inputs. Prints a JSON line of per-kernel results, the nvidia-smi line, and
last `{"ok": true, "device": {...}}`. Any failed check raises (non-zero
exit); without a GPU, or outside the repository, it exits non-zero and
prints no result.
"""

import argparse
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 8
TILE = 512
OVERLAP = 32
TILES_SIDE = 8  # an 8 x 8 block of tiles: 64 tiles, 8 batches
MAX_FLIP_SHARE = 0.001
SIGMOID_ULPS = 4
SEED = 0  # of the weights and the imagery
# H100 SXM peaks (NVIDIA's data sheet, dense): device memory, int8 tensor
# cores, float32 outside the tensor cores.
PEAK = {"bytes": 3.35e12, "int8": 1979e12, "f32": 67e12}
ROTATE_BYTES = 150e6  # inputs rotated through copies of at least this many bytes (3x the L2)
# Phase 9 (the vector tools): 9a's batch of masks; each handler's denoise and
# grow sizes (features/parking.py, building.py); 9b's generated block of label
# tiles at z18 (VECTOR_SIDE x VECTOR_SIDE tiles of TILE px) with its parking
# lots and buildings; merge's threshold in meters and dedupe's IoU threshold.
VECTOR_BATCH = 16
MORPH_SIZES = {"parking": (20, 20), "building": (9, 9)}
VECTOR_SIDE = 16
VECTOR_LOTS = 320
VECTOR_BUILDINGS = 900
MERGE_THRESHOLD = 2
DEDUPE_THRESHOLD = 0.5
# Phase 10 (the README's workflow on the port alone): a WORKFLOW_SIDE x
# WORKFLOW_SIDE block of z18 tiles around 13.4 E, 52.5 N, its generated map's
# closed parking ways, `download`'s rate, and the train batch (the config's
# 64 cut to fit the block's few training tiles).
WORKFLOW_SIDE = 6
WORKFLOW_X0, WORKFLOW_Y0 = 140846, 86034
WORKFLOW_LOTS = 40
WORKFLOW_RATE = 16
WORKFLOW_BATCH = 8
SERVE_TILES = 8  # z18 tiles requested from serve, then SERVE_REPEATS timed requests over them
SERVE_REPEATS = 16
SERVE_COMPARED = 4  # served tiles held against the CPU's segment step
SERVE_TIE = 1e-3  # a pixel whose CPU |l1 - l0| is below this share of the largest may flip
EXPORT_BATCH = 8
EXPORT_LAUNCHES = {"K1": 1}  # of the exported U-Net predict program, per batch

# Each kernel: its source, and the pallas_call of the TPU kernel it replaces.
SOURCES = {
    "K1": ("robosat_tpu_torch/csrc/head.cu", "robosat_tpu/ops/head.py:278"),
    "K2": ("robosat_tpu_torch/csrc/int8_mm.cu", "benchmarks/bench_pallas_mm.py:76"),
    "K3": ("robosat_tpu_torch/csrc/qenc.cu", "robosat_tpu/models/qenc.py:203"),
    "K4": ("robosat_tpu_torch/csrc/qenc.cu", "robosat_tpu/models/qenc.py:340"),
    "K5": ("robosat_tpu_torch/csrc/qdec.cu", "robosat_tpu/models/qdec.py:273"),
    "K6": ("robosat_tpu_torch/csrc/qtail.cu", "robosat_tpu/models/qtail.py:426"),
    "K7": ("robosat_tpu_torch/csrc/qtail.cu", "robosat_tpu/models/qtail.py:204"),
    "K8": ("robosat_tpu_torch/csrc/qdec.cu", "robosat_tpu/models/qdec.py:222"),
    "K9": ("robosat_tpu_torch/csrc/qtail.cu", "robosat_tpu/models/qtail.py:358"),
    "K10": ("robosat_tpu_torch/csrc/head_rungs.cu", "benchmarks/bisect_mosaic_head.py:108"),
    # No Pallas kernel: it stands in for XLA's int8 conv, which the fast family's walk calls.
    "int8_conv": ("robosat_tpu_torch/csrc/qconv.cu", "robosat_tpu/models/int8.py:228"),
    # No Pallas kernel: the activation quantize of SegFormer's dense sites, XLA's elementwise op.
    "quantize": ("robosat_tpu_torch/csrc/int8_mm.cu", "robosat_tpu/models/int8.py:209"),
}
ENCODER = {"K3": 13, "K4": 3}
# Substrings of the port's kernel names in torch.profiler's rows.
KERNEL_ROWS = ("conv_kernel", "tail_kernel", "up_kernel", "margin_head_kernel", "int8_mm_kernel", "head_rung_kernel",
               "quantize_act_kernel")
# An int8 conv kernel by name (any *conv_kernel, tail_kernel, up_kernel);
# every one must be an instance of csrc/int8_conv_sm90.cuh's, in rs::sm90.
INT8_CONV = re.compile(r"\b(\w*conv_kernel|tail_kernel|up_kernel)\b")
SM90 = "rs::sm90::"
# up_kernel's instances by output layout (template argument): K5 NHWC, per
# tensor or per channel (PC), K8 planes.
UP_KERNELS = (("K5", re.compile(r"rs::sm90::up_kernel<\d+, 0, (false|true)>")),
              ("K8", re.compile(r"rs::sm90::up_kernel<\d+, 1, false>")))
# K4's conv2: conv_kernel<BN, int8 input, EPI_RELU_Q8, stride 2, PC>; a K4
# block launches conv1, conv2, the projection, conv3 in that order.
K4_CONV2 = re.compile(r"rs::sm90::conv_kernel<\d+, false, 3, 2, (false|true)>")
# The predict paths: label, model TOML keys over config/model-unet.toml,
# predict's flags other than its defaults here, launches per batch of each
# kernel (every other kernel: 0).
STRIP = {"strip": 8}  # 8 strips of 8 tiles from the 8 x 8 block, one 4160 x 576 strip a batch
PATHS = (
    ("int8", {}, {}, {**ENCODER, "K5": 5, "K6": 1}),
    ("int8-tail", {"pallas_tail": "tail"}, {}, {**ENCODER, "K5": 5, "K7": 1, "K1": 1}),
    ("int8-sep", {"pallas_tail": "sep"}, {}, {**ENCODER, "K5": 4, "K8": 1, "K9": 1, "K1": 1}),
    ("int8-unfused", {"fused_head": False}, {}, {**ENCODER, "K5": 5, "K7": 1}),
    ("bf16", {"int8": False, "bf16": True}, {}, {"K1": 1}),
    ("int8-fine", {"host_s2d": False}, {}, {**ENCODER, "K5": 5, "K6": 1}),
    ("int8-strip", {}, STRIP, {**ENCODER, "K5": 5, "K6": 1}),
    ("int8-odd", {}, {"tile_size": 510, "overlap": 33}, {**ENCODER, "K5": 5, "K6": 1}),
    ("bf16-strip", {"int8": False, "bf16": True}, STRIP, {"K1": 1}),
)
# Phase 6 (train): dataset-parking's class weights; the gradient leaves and
# cosine floors of tests/test_torch_train_parity.py; steps of the card-vs-CPU
# check, of the configured step, of its profile and of the comparison with
# cuDNN's nondeterministic algorithms; the tool's dataset (8 x 8 training and
# 4 x 4 validation tiles) and batch.
PARKING_WEIGHTS = [1.6248, 5.762827]
COSINE_FLOORS = ((("final", "w"), 0.9999), (("dec3", "w"), 0.999), (("encoder", "layer3", 0, "conv2", "w"), 0.995),
                 (("encoder", "conv1", "w"), 0.99), (("encoder", "bn1", "scale"), 0.99))
TRAIN_CHECK_STEPS = 3
# Phase 6a's cosine floors card vs CPU over all weights after step 1, from the
# same weights: the update (weights minus the start) and each moment. Port vs
# JAX package on the CPU (its tests' weights and batches) measured 0.986-0.987,
# 0.9994 and 0.9992. After the last step the same cosines are printed, not
# held: the trajectories part as Adam's ~lr * sign(grad) updates follow the
# float noise of near-zero gradients (mu's cosine card vs CPU after step 3:
# 0.66, CrossEntropy, one H100).
TRAIN_UPDATE_FLOORS = {"update": 0.98, "mu": 0.998, "nu": 0.998}
TRAIN_STEPS = 10
PROFILE_STEPS = 3
TIMED_STEPS = 4
TRAIN_TILES_SIDE = 8
VAL_TILES_SIDE = 4
TOOL_BATCH = 16
# The configured step's kernels by kind, by name (first match wins).
TRAIN_KERNEL_GROUPS = (
    ("batch norm", re.compile(r"batch_norm|Welford")),
    ("convolution and matmul (cuDNN, cuBLAS)", re.compile(r"cudnn|xmma|conv|gemm|cutlass|sm90_|sm80_|wgrad|dgrad",
                                                          re.IGNORECASE)),
    ("sort (Lovasz)", re.compile(r"sort|radix", re.IGNORECASE)),
    ("Adam (foreach)", re.compile(r"multi_tensor_apply")),
    ("float copies and casts", re.compile(r"direct_copy|copy_kernel")),
)
# Phase 7b: the fake-quant elementwise kernels by name (its clamp and its
# multiplies share their kernels with relu and other products, and count
# as other elementwise), then the train step's kinds; the QAT contract's
# bound on 8 tiles of 512 px (mean and max |fake-quant - int8| over the
# int8 logits' max, decision agreement), from CPU analogues at 64 px, bf16
# fake-quant against the plain int8 walk: 0.0169-0.0183, 0.113-0.127,
# 0.9971-0.9973 (tests/test_torch_port_qat.py, the JAX package's init) and
# 0.0238, 0.172, 0.984 (He init after 4 QAT steps), with room for the max
# of 256 times as many logits.
QAT_KERNEL_GROUPS = (("fake quant (round, abs, gate compare, where)", re.compile(r"round|abs|compare|where",
                                                                                re.IGNORECASE)),) + TRAIN_KERNEL_GROUPS
QAT_CONTRACT = (0.05, 0.5, 0.95)
# Phase 8 (the fast family, config/model-fast.toml): its dense sites with
# (stride, dilation, epilogue), in walk order with the up-sites between;
# launches per batch on its int8 path; the predict paths (label, model TOML
# keys over config/model-fast.toml, launches per batch).
FAST_TOML = os.path.join(ROOT, "config", "model-fast.toml")
FAST_DENSE = {"stem": (1, 1, "relu"), "b1": (1, 1, "residual_relu"), "down2": (2, 1, "relu"),
              "b2": (1, 1, "residual_relu"), "down3": (2, 1, "relu"), "b3": (1, 1, "residual_relu"),
              "down4": (2, 1, "relu"), "b4a": (1, 1, "residual_relu"), "b4b": (1, 2, "residual_relu"),
              "d3": (1, 1, "relu"), "d2": (1, 1, "relu"), "d1": (1, 1, "relu")}
FAST_INT8 = {"int8_conv": 12, "K5": 3}
# rs_int8_conv's route at each dense site (qconv.route), and its launches
# per batch by route on the int8 path.
FAST_ROUTES = {name: "conv_kernel" if name.startswith("down") else "halo" for name in FAST_DENSE}
FAST_INT8_ROUTES = {"halo": 9, "conv_kernel": 3}
FAST_PATHS = (("fast-int8", {}, FAST_INT8), ("fast-bf16", {"int8": False}, {}))
# Phase 11 (DeepLabv3+, config/model-unet.toml with model = "deeplabv3plus"):
# launches per batch on its int8 path (layers 1-3's 11 stride-1 blocks and
# layer4's 3 dilated ones on K3, layer2.0 and layer3.0 on K4, ASPP's and the
# decoder's 7 dense sites on rs_int8_conv), those by route, and the predict
# paths (label, model TOML keys, launches per batch).
DEEPLAB_INT8 = {"K3": 14, "K4": 2, "int8_conv": 7}
DEEPLAB_INT8_ROUTES = {"halo": 2, "conv_kernel": 5}
DEEPLAB_PATHS = (("deeplab-int8", {}, DEEPLAB_INT8), ("deeplab-bf16", {"int8": False, "bf16": True}, {}))
# Phase 12 (SegFormer, config/model-unet.toml with model = "segformer"):
# launches per batch on its int8 path (51 dense and spatial-reduction sites,
# each the quantize kernel and K2's dequant epilogue; the 3 patch embeds on
# rs_int8_conv's conv_kernel), those by route, and the predict paths.
SEGFORMER_INT8 = {"K2": 51, "quantize": 51, "int8_conv": 3}
SEGFORMER_INT8_ROUTES = {"halo": 0, "conv_kernel": 3}
SEGFORMER_PATHS = (("segformer-int8", {}, SEGFORMER_INT8), ("segformer-bf16", {"int8": False, "bf16": True}, {}))
# Phase 13 (the per-channel calibration): its spec, and the U-Net's predict
# path under it (label, model TOML keys over config/model-unet.toml,
# launches per batch: those of phase 5's int8 path).
PC_SPEC = "pc99.8"
PC_PATHS = (("unet-" + PC_SPEC, {"int8_calibration": PC_SPEC}, {**ENCODER, "K5": 5, "K6": 1}),)
MESH_RASTER = 2048  # phase 14b: one raster of this side, split by height over the ranks
MESH_RANKS = 2
MESH_TRAIN_STEPS = 3
# The int8 predicts from a trained checkpoint (6c, 10, 11c, 12c) and phase
# 14's calibrate on amax: a per-tensor 99.8 percentile calibration takes
# ~10 s of the card (one kthvalue over a site's 42M values), and the
# configured 99.8 already runs in phases 5, 7c (QAT), 8b, 11b and 12b.
TRAINED_CALIBRATION = MESH_CALIBRATION = "amax"
# Step 0's loss in bf16 between the synchronized batch norm (the JAX
# package's float32 formula, one rounding to bf16) and cuDNN's: the two
# round apart (6.7-7.2e-4 relative on one H100, where bf16 and float32
# steps without a mesh part by 4.0e-3), so the bf16 steps are held to
# about 3x that gap, and PERF.md section 2's 1e-4 holds in float32.
MESH_BF16_STEP0 = 2e-3
MESH_F32_ROWS = 8  # 14a's float32 comparison: the first rows of the batch
EDGE_ROWS = 128  # rows next to a tile edge inside a strip, where a strip's context exceeds the tile's
# Paths that run on phase 3's scales through a QAT checkpoint's qat_amaxes
# (every int8 path but the configured one, which calibrates in `predict`).
QAT_PATHS = ("int8-tail", "int8-sep", "int8-unfused", "int8-fine", "int8-strip", "int8-odd")
# Each path's PNGs against earlier paths': (other path, held to +-1 bin on
# <= 0.1% of pixels, or counted only, for the reason in NOT_HELD).
COMPARED = {
    "int8-tail": (("int8", True),), "int8-sep": (("int8", True),), "int8-unfused": (("int8", False),),
    "int8-fine": (("int8", False),), "int8-strip": (("int8-fine", False),), "bf16-strip": (("bf16", False),),
}
NOT_HELD = {
    "int8-unfused": "another head, bf16 logits and a softmax",
    "int8-fine": "another stem, whose bf16 sums cuDNN orders otherwise",
    "int8-strip": "a strip's tiles see their column neighbors past the overlap",
    "bf16-strip": "a strip's tiles see their column neighbors past the overlap",
}


def log(*parts):
    print(*parts, flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--k2", action="store_true",
                        help="only phases 1, 2 and K2's part of phase 4 (bit-equality, events and device times)")
    parser.add_argument("--train", action="store_true",
                        help="only phases 1, 6b and 7b (the configured train, QAT and distillation steps)")
    parser.add_argument("--fast", action="store_true",
                        help="only phases 1, 2 and 8 (the fast family: its kernels, predict, train steps and tools)")
    parser.add_argument("--vector", action="store_true",
                        help="only phases 1 and 9 (denoise + grow on the card, features, merge and dedupe)")
    parser.add_argument("--workflow", action="store_true",
                        help="only phases 1, 2 and 10 (the README's workflow, OSM to GeoJSON, on the port alone)")
    parser.add_argument("--deeplab", action="store_true",
                        help="only phases 1, 2 and 11 (DeepLabv3+: its kernels, predict, train step and tools)")
    parser.add_argument("--deeplab-from", default=None, metavar="WORK",
                        help="with --deeplab: the full run's work directory, whose phase-6c dataset phase 11c "
                             "uses; the results go to WORK/deeplab.json (the full run's phase 11)")
    parser.add_argument("--segformer", action="store_true",
                        help="only phases 1, 2 and 12 (SegFormer: its kernels, predict, train step and tools)")
    parser.add_argument("--segformer-from", default=None, metavar="WORK",
                        help="with --segformer: the full run's work directory, whose phase-6c dataset phase 12c "
                             "uses; the results go to WORK/segformer.json (the full run's phase 12)")
    parser.add_argument("--pc", action="store_true",
                        help="only phases 1, 2 and 13 (the per-channel calibration: its kernel instantiations, "
                             "predict for the U-Net, the fast family's and DeepLab's steps)")
    parser.add_argument("--pc-from", default=None, metavar="WORK",
                        help="with --pc: the full run's work directory; the results go to WORK/pc.json (the full "
                             "run's phase 13)")
    parser.add_argument("--mesh", action="store_true",
                        help="only phases 1, 2 and 14 (the multi-device layer: a one-rank NCCL group, then two "
                             "ranks over gloo on the one card)")
    parser.add_argument("--mesh-from", default=None, metavar="WORK",
                        help="with --mesh: the full run's work directory, whose phase-6c dataset phase 14 uses; the "
                             "results go to WORK/mesh.json (the full run's phase 14)")
    parser.add_argument("--mesh-rank", default=None, choices=("nccl", "gloo"),
                        help="one rank of phase 14, started by it with RS_* set (with --mesh-from WORK)")
    parser.add_argument("--fast-from", default=None, metavar="WORK",
                        help="with --fast: the full run's work directory, whose phase-6c U-Net checkpoint and "
                             "dataset phase 8d uses; the results go to WORK/fast.json (the full run's phase 8)")
    parser.add_argument("--tree", default=ROOT,
                        help="with --k2 or --train: the checkout whose robosat_tpu_torch to build and time "
                             "(default: this one)")
    opts = parser.parse_args()
    root = os.path.abspath(opts.tree if (opts.k2 or opts.train) else ROOT)
    if not os.path.isdir(os.path.join(root, "robosat_tpu_torch", "csrc")):
        sys.exit("chip_smoke.py must run from a checkout of the repository (robosat_tpu_torch/ not found)")
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA GPU (torch.cuda.is_available() is false)")
    if opts.mesh_rank:
        run_mesh_rank(torch, opts.mesh_rank, opts.mesh_from)
        return

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log("phase 1: card {} | torch {} | CUDA {} | {} device(s)".format(
        smi, torch.__version__, torch.version.cuda, torch.cuda.device_count()))

    if opts.train:
        from robosat_tpu_torch.device import configure_device

        configure_device(True)
        result = configured_train_step(torch, SEED, smi)
        qat = configured_qat_distill_steps(torch, SEED, smi, result.pop("trained"), wrappers())
        log(json.dumps({"6b": {k: v for k, v in result.items() if k != "losses"},
                        "7b": {k: v for k, v in qat.items() if k != "launches"}, "tree": root}))
        log(smi)
        return

    if opts.vector:
        with tempfile.TemporaryDirectory(prefix="rs_chip_smoke_") as work:
            summary = run_vector(torch, work, smi)
        log(json.dumps({"vector": summary}))
        log(smi)
        return

    from robosat_tpu_torch import kernels

    start = time.perf_counter()
    kernels.library()
    log("phase 2: kernels built and loaded in {:.1f} s (nvcc {}) -> {}".format(
        time.perf_counter() - start,
        "skipped, cached" if kernels.build_seconds is None else "{:.1f} s".format(kernels.build_seconds),
        os.path.relpath(kernels.library_path(), root)))

    if opts.workflow:
        with tempfile.TemporaryDirectory(prefix="rs_chip_smoke_") as work:
            summary = run_workflow(torch, work, SEED, smi, wrappers())
        log(json.dumps({"workflow": summary}))
        log(smi)
        return

    if opts.k2:
        from robosat_tpu_torch.ops import int8_mm

        device = torch.device("cuda")
        per_kernel = {}
        k2 = k2_operands(torch, device, torch.Generator(device=device).manual_seed(SEED + 1), int8_mm)
        int8_mm.int8_matmul_requant.launches = 0
        with torch.no_grad():
            k2_out = [int8_mm.int8_matmul_requant(*args, orient) for _, orient, args in k2]
        torch.cuda.synchronize()
        if int8_mm.int8_matmul_requant.launches != len(k2):
            raise AssertionError("K2: {} launches, expected {}".format(int8_mm.int8_matmul_requant.launches, len(k2)))
        check_and_time_k2(torch, int8_mm, k2, k2_out, per_kernel, smi)
        log(json.dumps({"K2": per_kernel["K2"], "tree": root}))
        log(smi)
        return

    if opts.fast:
        per_kernel, launches, by_path = {}, {"int8_conv": 0, "K5": 0}, {}
        if opts.fast_from:
            run_fast(torch, opts.fast_from, SEED, smi, wrappers(), launches, by_path, per_kernel,
                     unet_checkpoint=tool_checkpoint_path(opts.fast_from),
                     train_root=os.path.join(opts.fast_from, "slippy"))
            with open(os.path.join(opts.fast_from, "fast.json"), "w") as f:
                json.dump({"per_kernel": per_kernel, "launches": launches, "by_path": by_path}, f)
            return
        with tempfile.TemporaryDirectory(prefix="rs_chip_smoke_") as work:
            run_fast(torch, work, SEED, smi, wrappers(), launches, by_path, per_kernel)
        log(json.dumps({"kernels": [{"name": name, "launches": launches[name], **per_kernel[name]}
                                    for name in launches]}))
        log(smi)
        return

    for flag, run_family, names, from_work in (("deeplab", run_deeplab, ("K3", "K4", "int8_conv"), opts.deeplab_from),
                                               ("segformer", run_segformer, ("K2", "quantize", "int8_conv"),
                                                opts.segformer_from),
                                               ("pc", run_pc, ("K3", "K4", "K5", "K6", "int8_conv"), opts.pc_from),
                                               ("mesh", run_mesh, ("K1", "K3", "K4", "K5", "K6"), opts.mesh_from)):
        if not getattr(opts, flag):
            continue
        per_kernel, launches, by_path = {}, dict.fromkeys(names, 0), {}
        if from_work:
            run_family(torch, from_work, SEED, smi, wrappers(), launches, by_path, per_kernel,
                       train_root=os.path.join(from_work, "slippy"))
            with open(os.path.join(from_work, flag + ".json"), "w") as f:
                json.dump({"per_kernel": per_kernel, "launches": launches, "by_path": by_path}, f)
            return
        with tempfile.TemporaryDirectory(prefix="rs_chip_smoke_") as work:
            run_family(torch, work, SEED, smi, wrappers(), launches, by_path, per_kernel)
        log(json.dumps({"kernels": [{"name": name, "launches": launches[name], "launches_by_path": {
            p: c[name] for p, c in by_path.items() if name in c}, **per_kernel.get(name, {})} for name in launches]}))
        log(smi)
        return

    with tempfile.TemporaryDirectory(prefix="rs_chip_smoke_") as work:
        results = run(torch, work, SEED, smi)

    log(json.dumps({"kernels": results}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


def lap(marks, phase):
    """Log the seconds since the last of `marks` as `phase`'s, and mark now."""
    now = time.perf_counter()
    log("{}: {:.1f} s (the run's {:.1f} s so far)".format(phase, now - marks[-1], now - marks[0]))
    marks.append(now)


def u8_flips(torch, got, ref):
    """(count of differing bins, largest bin distance modulo 256)."""
    d = (got.int() - ref.int()) % 256
    d = torch.minimum(d, 256 - d)
    return int((d != 0).sum()), int(d.max()) if d.numel() else 0


def cuda_ms(torch, fn, arg_sets, reps):
    """Mean milliseconds of fn(*args) over `reps` runs that cycle through
    `arg_sets` (copies of the same inputs, so a run finds its inputs out of
    L2, as the main path would), after one warm-up, by CUDA events."""
    fn(*arg_sets[0])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, arg_sets, reps, rows=KERNEL_ROWS):
    """Mean device milliseconds per fn(*args) of the port's kernels only
    (torch.profiler's kernel rows whose names hold one of `rows`; the
    wrapper's host work and PyTorch's own small kernels excluded; every
    kernel when `rows` is None), over `reps` runs cycling through
    `arg_sets`; None when the profiler records no kernel time."""
    from torch.profiler import ProfilerActivity, profile

    fn(*arg_sets[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(*arg_sets[i % len(arg_sets)])
        torch.cuda.synchronize()
    us = sum(k.self_device_time_total for k in prof.key_averages()
             if k.device_type == torch.autograd.DeviceType.CUDA and (rows is None or any(r in k.key for r in rows)))
    return us / 1e3 / reps if us > 0 else None


def rotated(torch, args):
    """`args` and enough copies of its tensors that one cycle through them
    holds at least ROTATE_BYTES."""
    size = nbytes(*(a for a in args if torch.is_tensor(a)))
    copies = max(1, math.ceil(ROTATE_BYTES / max(size, 1)))
    return [args] + [tuple(a.clone() if torch.is_tensor(a) else a for a in args) for _ in range(copies - 1)]


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved, ops, op_type):
    """(ms, "bytes" or "operations"): the least time the card could take to
    move `bytes_moved` and do `ops` operations of `op_type`."""
    t_bytes = bytes_moved / PEAK["bytes"]
    t_ops = ops / PEAK[op_type]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def site_work(name, kargs, out):
    """(bytes, operations, operation type) of a phase-3 or phase-8 kernel
    call: the activations and int8 weights read once (a residual is the
    conv's own input), the output written once, two
    operations per multiply-accumulate (K5/K8: four 2x2-tap parity convs,
    16 taps per coarse pixel; K6/K7/K9: dec4 the same way, then dec5 at the
    fine grid; K1: a multiply and an add per feature)."""
    x = kargs[0]
    io = nbytes(x, out)
    if name in ("K3", "K4"):
        qb, stride = kargs[1], 2 if name == "K4" else 1
        n, h, w, cin = x.shape
        cmid, cout = qb["conv1"]["wq"].shape[-1], qb["conv3"]["wq"].shape[-1]
        lo = n * (h // stride) * (w // stride)
        macs = n * h * w * cin * cmid + lo * (9 * cmid * cmid + cmid * cout + (cin * cout if "down_conv" in qb else 0))
        return io + nbytes(*(node["wq"] for node in qb.values())), 2 * macs, "int8"
    if name in ("K5", "K8"):
        node = kargs[1]
        return io + nbytes(node["wq"]), 2 * x.numel() * 16 * node["wq"].shape[-1], "int8"
    if name == "int8_conv":  # a dense k x k conv: Cin * k^2 MACs per output element
        wq = kargs[1]["wq"]
        return io + nbytes(wq), 2 * out.numel() * wq.shape[0] * wq.shape[1] * wq.shape[2], "int8"
    if name in ("K6", "K7", "K9"):
        # The work the function needs, not that of the s2d weights' dense
        # 3x3 128 -> 128 form: dec4, nearest-up x2 then 3x3 cin -> c, as four
        # 2x2-tap parity convs per coarse pixel; dec5, 3x3 c -> c per fine pixel.
        coarse = x.numel() // 128  # pixels of the 2x2 s2d grid (K9's planes hold four per plane pixel)
        cin, c = kargs[1]["wq"].shape[-2], kargs[3]["wq"].shape[-1] // 4
        macs = coarse * (16 * cin * c + 4 * 9 * c * c)
        return io + nbytes(kargs[1]["wq"], kargs[3]["wq"]), 2 * macs, "int8"
    return io + 33 * 4, 2 * x.numel(), "f32"  # K1


def record(per_kernel, name, site, shape, err, ms, plain_ms, work, library_ms=None, **extra):
    """Add one site's numbers to kernel `name`'s entry; returns its bound."""
    bound_ms, bound_by = bound(*work)
    add_site(per_kernel, name, {"site": site, "shape": list(shape), "ms": ms, "plain_ms": plain_ms,
                                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
                                "max_abs_err": err, **extra})
    return bound_ms, bound_by


def add_site(per_kernel, name, site):
    """Add a site's record (as `record` makes it) to kernel `name`'s sums."""
    entry = per_kernel.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                                         "bound_by": None, "library_ms": None, "sites": []})
    entry["max_abs_err"] = max(entry["max_abs_err"], site["max_abs_err"])
    for key in ("ms", "plain_ms", "bound_ms"):
        entry[key] += site[key]
    if site["library_ms"] is not None:
        entry["library_ms"] = (entry["library_ms"] or 0.0) + site["library_ms"]
    entry["sites"].append(site)
    entry["bound_by"] = max(entry["sites"], key=lambda e: e["bound_ms"])["bound_by"]


def profile_kernels(torch, step, steps):
    """torch.profiler over `steps` calls of step() after one warm-up: (wall
    ms per step on the host's clock, synchronized; the CUDA kernel rows as
    (device ms per step, launches per step, name), costliest first; the
    profile)."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3 / steps
    rows = [(k.self_device_time_total / 1e3 / steps, k.count // steps, k.key) for k in prof.key_averages()
            if k.device_type == torch.autograd.DeviceType.CUDA and k.self_device_time_total > 0]
    rows.sort(reverse=True)
    return wall_ms, rows, prof


def kernel_split(torch, step, steps=5):
    """(wall ms, kernel ms) per call of step() over `steps` calls under
    torch.profiler (`profile_kernels`); kernel ms None when the profiler
    records no device time."""
    wall_ms, rows, _ = profile_kernels(torch, step, steps)
    return wall_ms, (sum(r[0] for r in rows) if rows else None)


def log_step_profile(torch, step, label, per_batch, steps=5, top=8, phase="phase 5"):
    """Where one step's device time goes: torch.profiler's CUDA kernel rows
    over `steps` steps, against their wall time (host clock, synchronized),
    and the int8 convs' time summed; raises if an int8 conv ran outside
    rs::sm90 or if up_kernel's launches per step are not the path's K5 + K8
    (`per_batch`)."""
    wall_ms, rows, prof = profile_kernels(torch, step, steps)
    if not rows:
        log(phase + ": [{}] profile of the step: the profiler recorded no kernel time (device split not measured)"
            .format(label))
        return
    busy = sum(r[0] for r in rows)
    log(phase + ": [{}] profile of the step: {:.2f} ms wall (profiled), {:.2f} ms of kernels, device idle {:.1%}"
        .format(label, wall_ms, busy, 1 - busy / wall_ms))
    for ms, count, key in rows[:top]:
        log(phase + ": [{}]   {:8.3f} ms/step {:4d} launches  {}".format(label, ms, count, key[:100]))
    convs = [r for r in rows if INT8_CONV.search(r[2])]
    outside = [r[2] for r in convs if SM90 not in r[2]]
    if outside:
        raise AssertionError("[{}] int8 convs outside {}: {}".format(label, SM90, outside))
    log(phase + ": [{}]   int8 convs, all on int8_conv_sm90.cuh ({}): {:.3f} ms/step, {} launches, {} kernels".format(
        label, SM90, sum(r[0] for r in convs), sum(r[1] for r in convs), len(convs)))
    mine = [r for r in rows if SM90 + "tail_kernel" in r[2]]
    if mine:
        log(phase + ": [{}]   K6/K7/K9 by kernel name (tail_kernel): {:.3f} ms/step, {} launches".format(
            label, sum(r[0] for r in mine), sum(r[1] for r in mine)))
    for name, row in (("K2", "int8_mm_kernel"), ("quantize", "quantize_act_kernel")):
        mine = [r for r in rows if row in r[2]]
        if mine:
            log(phase + ": [{}]   {} by kernel name ({}): {:.3f} ms/step, {} launches".format(
                label, name, row, sum(r[0] for r in mine), sum(r[1] for r in mine)))
    for name, pattern in UP_KERNELS:
        mine = [r for r in rows if pattern.search(r[2])]
        if sum(r[1] for r in mine) != per_batch.get(name, 0):
            raise AssertionError("[{}] {} up_kernel launches per step, expected {}".format(
                label, sum(r[1] for r in mine), per_batch.get(name, 0)))
        if mine:
            log(phase + ": [{}]   {} by kernel name (up_kernel, {}): {:.3f} ms/step, {} launches".format(
                label, name, "parity planes" if name == "K8" else "NHWC", sum(r[0] for r in mine),
                sum(r[1] for r in mine)))
    # K4 by kernel name and launch order: the convs in the order they ran.
    convs = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                    and "rs::sm90::conv_kernel" in e.name), key=lambda e: e.time_range.start)
    blocks = [convs[i - 1:i + 3] for i, e in enumerate(convs) if i >= 1 and K4_CONV2.search(e.name)]
    if blocks:
        log(phase + ": [{}]   K4 by kernel name (conv1, stride-2 conv2, stride-2 projection, conv3): {:.3f} ms/step, "
            "{} blocks, {} launches".format(label, sum(e.time_range.elapsed_us() for b in blocks for e in b) / 1e3 / steps,
                                            len(blocks) // steps, sum(map(len, blocks)) // steps))


def write_tiles(root, seed):
    """A deterministic TILES_SIDE x TILES_SIDE block of 512-px RGB tiles at z18."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:TILE, 0:TILE].astype(np.float32)
    tiles = []
    for i in range(TILES_SIDE):
        for j in range(TILES_SIDE):
            x, y, z = 69620 + i, 104940 + j, 18
            phase = rng.uniform(0, 2 * np.pi, 3)
            base = 0.5 + 0.35 * np.stack([np.sin(xx / (23 + 7 * c) + yy / (31 + 5 * c) + phase[c]) for c in range(3)], -1)
            img = np.clip(base * 255 + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8)
            path = os.path.join(root, str(z), str(x))
            os.makedirs(path, exist_ok=True)
            Image.fromarray(img).save(os.path.join(path, "{}.png".format(y)), compress_level=1)
            tiles.append((x, y, z))
    return tiles


class Launches:
    """The launch count of a kernel behind several wrappers (K2: its
    requantize and its dequant epilogue), read and set as one wrapper's."""

    def __init__(self, *wrappers):
        self.wrappers = wrappers

    @property
    def launches(self):
        return sum(fn.launches for fn in self.wrappers)

    @launches.setter
    def launches(self, value):
        for fn in self.wrappers:
            fn.launches = value


def wrappers():
    """Each kernel's wrapper, whose `.launches` counts its launches."""
    from robosat_tpu_torch.models import qconv, qdec, qenc, qtail
    from robosat_tpu_torch.ops import head, head_rungs, int8_mm

    return {"K1": head.margin_head, "K2": Launches(int8_mm.int8_matmul_requant, int8_mm.int8_matmul_dequant),
            "K3": qenc.bottleneck_block, "K4": qenc.bottleneck_block_s2, "K5": qdec.parity_up_conv,
            "K6": qtail.fused_tail, "K7": qtail.fused_tail_features, "K8": qdec.parity_up_conv_separated,
            "K9": qtail.fused_tail_features_sep, "K10": head_rungs.head_rung, "int8_conv": qconv.int8_conv,
            "quantize": int8_mm.quantize_act}


def predict_args(work, tiles_dir, probs, model_toml, checkpoint, **flags):
    """`predict`'s arguments for one path: batch 8 of 512-px tiles at
    overlap 32 unless `flags` says otherwise."""
    args = dict(batch_size=BATCH, checkpoint=checkpoint, overlap=OVERLAP, strip=1, tile_size=TILE, workers=4,
                shard=None, tiles=tiles_dir, probs=probs, model=model_toml,
                dataset=os.path.join(ROOT, "config", "dataset-parking.toml"), profile=None, png_optimize=False)
    args.update(flags)
    return argparse.Namespace(**args)


def strip_edge_shares(differ, tiles, strip):
    """(share of differing pixels within EDGE_ROWS rows of a tile edge that
    a strip shares with the next tile, share elsewhere) over `tiles` (x, y,
    z) and their (n, H, W) mask `differ`; strips start at each column's
    first y, as the 8 x 8 block's columns do."""
    first_y = min(y for _, y, _ in tiles)
    near = np.zeros(differ.shape, bool)
    for i, (_, y, _) in enumerate(tiles):
        k = (y - first_y) % strip
        if k > 0:
            near[i, :EDGE_ROWS] = True
        if k < strip - 1:
            near[i, -EDGE_ROWS:] = True
    return float(differ[near].mean()), float(differ[~near].mean())


def batch_tiles(batch, strip):
    """A loader batch's tiles in the order of its fine output rows."""
    if strip > 1:
        return [tuple(t) for tiles, valid in batch.meta for t in tiles[:valid]]
    return [tuple(t) for t in batch.meta]


def check_trace(trace_dir, n_batches):
    """`predict --profile`'s trace: one TensorBoard trace file holding a
    predict_batch range per batch and the port's kernels (conv_kernel for
    K3/K4, tail_kernel for K6) among its device rows."""
    traces = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")] if os.path.isdir(trace_dir) else []
    if len(traces) != 1:
        raise AssertionError("[profiled] {} trace files in {}, expected 1".format(len(traces), trace_dir))
    with open(os.path.join(trace_dir, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    # The host's ranges (the device timeline repeats each as a gpu_user_annotation).
    ranges = sum(e.get("name") == "predict_batch" and e.get("cat") == "user_annotation" for e in events)
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    rows = {row: sum(row in k for k in kernels) for row in ("conv_kernel", "tail_kernel")}
    if ranges != n_batches or not all(rows.values()):
        raise AssertionError("[profiled] trace holds {} predict_batch ranges (expected {}) and kernel rows {}".format(
            ranges, n_batches, rows))
    log("phase 5: [profiled] trace {} ({:.1f} MB): {} predict_batch ranges, {} kernel events, {}".format(
        traces[0], os.path.getsize(os.path.join(trace_dir, traces[0])) / 1e6, ranges, len(kernels), rows))


def fine_u8(out):
    """A step's uint8 (fine, blocked (..., 4) or doubly blocked (..., 16)) as fine tiles on the host."""
    from robosat_tpu_torch.models.layers import depth_to_space2

    q = out.cpu().numpy()
    if q.ndim == 3:
        return q
    if q.shape[-1] == 16:
        q = depth_to_space2(q)
    return depth_to_space2(q)[..., 0]


def read_pngs(probs, tiles):
    from PIL import Image

    return np.stack([np.asarray(Image.open(os.path.join(probs, str(z), str(x), "{}.png".format(y))))
                     for (x, y, z) in tiles])


def run(torch, work, seed, smi):
    from robosat_tpu_torch.checkpoint import load_model_checkpoint, save_checkpoint, to_jax
    from robosat_tpu_torch.data.loader import batches
    from robosat_tpu_torch.device import configure_device
    from robosat_tpu_torch.models import int8 as q8
    from robosat_tpu_torch.models import qdec, qenc, qtail, unet
    from robosat_tpu_torch.ops import head
    from robosat_tpu_torch.parallel.steps import _normalize_s2d4
    from robosat_tpu_torch.tools import predict

    marks = [time.perf_counter()]
    device = configure_device(True)
    tiles_dir = os.path.join(work, "tiles")
    tiles = write_tiles(tiles_dir, seed)
    params, state = unet.init(seed, num_classes=2)
    checkpoint = os.path.join(work, "unet.npz")
    save_checkpoint(checkpoint, {"params": to_jax(params), "state": to_jax(state)}, meta={"epoch": 0})

    # The first loader batch of the int8 path, exactly as predict builds it.
    directory, _ = predict.input_directory(predict_args(work, tiles_dir, None, None, checkpoint), True)
    raw48 = next(iter(batches(directory, BATCH, workers=2))).arrays[0]
    if raw48.shape != (BATCH, (TILE + 2 * OVERLAP) // 4, (TILE + 2 * OVERLAP) // 4, 48):
        raise AssertionError("first batch has shape {}".format(raw48.shape))

    # ---- phase 3: kernels vs plain versions at main-path shapes ----------
    params_d, state_d, _ = load_model_checkpoint(checkpoint, device=device)
    with torch.no_grad():
        folded = unet.fold(params_d, state_d)
        x48 = _normalize_s2d4(torch.as_tensor(raw48).to(device))
        amaxes = q8.calibration_amaxes(folded, x48, blocked=True, percentile=99.8)
        if not torch.equal(amaxes, q8.calibration_amaxes(folded, x48, blocked=True, percentile=99.8)):
            raise AssertionError("calibration is not reproducible on the card")
        del x48
        log("phase 3: float32 calibration of {} sites is reproducible".format(len(amaxes)))
        scales = q8.scales_from_amaxes(amaxes)
        qtree = q8.quantize_unet_folded(folded)
    enc = qtree["encoder"]
    w_final, b_final = qtree["final"]["w"], qtree["final"]["b"]
    gen = torch.Generator(device=device).manual_seed(seed)

    def act(shape, site, dtype=torch.bfloat16):
        """Relu'd activations spanning site `site`'s int8 range."""
        x = torch.randn(shape, generator=gen, device=device).relu_() * float(amaxes[site] / 3.0)
        return x.to(dtype)

    def block_scales(first_site, down):
        return [float(s) for s in scales[first_site:first_site + (4 if down else 3)]]

    n, side = BATCH, (TILE + 2 * OVERLAP) // 4  # 144: the stem's output grid
    s3, s4, s5 = (float(s) for s in scales[56:59])  # dec3, dec4, dec5
    # (name, site, kernel, plain, args, bit-equal?)
    # K3 at one block of each stage: (stage, block, its first site, its input grid and channels)
    k3_sites = (("layer1", 0, 0, side, 64), ("layer1", 1, 4, side, 256), ("layer2", 1, 14, side // 2, 512),
                ("layer3", 1, 27, side // 4, 1024), ("layer4", 1, 46, side // 8, 2048))
    # K4 at the first block of layers 2-4 and K5 at every up-block: (name, first site, input grid and channels)
    k4_sites = (("layer2", 10, side, 256), ("layer3", 23, side // 2, 512), ("layer4", 42, side // 4, 1024))
    k5_sites = (("center", 52, side // 16, 2048), ("dec0", 53, side // 8, 2304), ("dec1", 54, side // 4, 1280),
                ("dec2", 55, side // 2, 768), ("dec3", 56, side, 320))
    checks = [
        ("K3", "{}.{} ({})".format(stage, bi, "projection" if bi == 0 else "identity"), qenc.bottleneck_block,
         qenc.bottleneck_block_plain, (act((n, grid, grid, cin), site), enc[stage][bi], *block_scales(site, bi == 0)),
         True)
        for stage, bi, site, grid, cin in k3_sites
    ] + [
        ("K4", "{}.0".format(stage), qenc.bottleneck_block_s2, qenc.bottleneck_block_s2_plain,
         (act((n, grid, grid, cin), site), enc[stage][0], *block_scales(site, True)), True)
        for stage, site, grid, cin in k4_sites
    ] + [
        ("K5", name, qdec.parity_up_conv, qdec.parity_up_conv_plain,
         (act((n, grid, grid, cin), site), qtree[name], float(scales[site])), True)
        for name, site, grid, cin in k5_sites
    ] + [
        ("K6", "dec3 -> head", qtail.fused_tail, qtail.fused_tail_plain,
         (act((n, 2 * side, 2 * side, 128), 57), qtree["dec4"], s4, qtree["dec5"], s5, w_final, b_final, OVERLAP),
         False),
        ("K7", "dec4 + dec5", qtail.fused_tail_features, qtail.fused_tail_features_plain,
         (act((n, 2 * side, 2 * side, 128), 57), qtree["dec4"], s4, qtree["dec5"], s5), True),
        ("K8", "dec3 (separated)", qdec.parity_up_conv_separated, qdec.parity_up_conv_separated_plain,
         (act((n, side, side, 320), 56), qtree["dec3"], s3), True),
        ("K9", "dec4 + dec5 (planes)", qtail.fused_tail_features_sep, qtail.fused_tail_features_sep_plain,
         (act((n, side, side, 512), 57), qtree["dec4"], s4, qtree["dec5"], s5), True),
    ]
    # The sites of a --strip 8 batch: one 4160 x 576 image, its stem grid 1040 x 144.
    tall = (STRIP["strip"] * TILE + 2 * OVERLAP) // 4
    checks += [
        ("K3", "layer1.0 (projection), strip", qenc.bottleneck_block, qenc.bottleneck_block_plain,
         (act((1, tall, side, 64), 0), enc["layer1"][0], *block_scales(0, True)), True),
        ("K3", "layer4.1 (identity), strip", qenc.bottleneck_block, qenc.bottleneck_block_plain,
         (act((1, tall // 8, side // 8, 2048), 46), enc["layer4"][1], *block_scales(46, False)), True),
        ("K4", "layer2.0, strip", qenc.bottleneck_block_s2, qenc.bottleneck_block_s2_plain,
         (act((1, tall, side, 256), 10), enc["layer2"][0], *block_scales(10, True)), True),
        ("K5", "center, strip", qdec.parity_up_conv, qdec.parity_up_conv_plain,
         (act((1, tall // 16, side // 16, 2048), 52), qtree["center"], float(scales[52])), True),
        ("K5", "dec3, strip", qdec.parity_up_conv, qdec.parity_up_conv_plain,
         (act((1, tall, side, 320), 56), qtree["dec3"], float(scales[56])), True),
        ("K6", "dec3 -> head, strip, overlap 0", qtail.fused_tail, qtail.fused_tail_plain,
         (act((1, 2 * tall, 2 * side, 128), 57), qtree["dec4"], s4, qtree["dec5"], s5, w_final, b_final, 0), False),
    ]
    # K1 on dec5-like features (relu'd, unit scale) of each layout and dtype,
    # and at G = 4 in bf16 on a strip (overlap 0), as bf16-strip runs it.
    feats = torch.randn((1, 2 * tall, 2 * side, 128), generator=gen, device=device).relu_().to(torch.bfloat16)
    checks.append(("K1", "G = 4 bfloat16, strip", head.margin_head, head.margin_head_plain,
                   (feats, w_final, b_final, 0, 4), False))
    for groups, grid in ((1, 4 * side), (4, 2 * side), (16, side)):
        for dtype in (torch.float32, torch.bfloat16):
            feats = torch.randn((n, grid, grid, 32 * groups), generator=gen, device=device).relu_().to(dtype)
            checks.append(("K1", "G = {} {}".format(groups, str(dtype)[6:]), head.margin_head, head.margin_head_plain,
                           (feats, w_final, b_final, OVERLAP, groups), False))
    per_kernel = {}
    with torch.no_grad():
        for name, site, kernel, plain, kargs, bit_equal in checks:
            got = kernel(*kargs)
            ref = plain(*kargs)
            torch.cuda.synchronize()
            if got.shape != ref.shape or got.dtype != ref.dtype:
                raise AssertionError("{} {}: kernel {} {} vs plain {} {}".format(
                    name, site, tuple(got.shape), got.dtype, tuple(ref.shape), ref.dtype))
            if not bit_equal:
                flips, err = u8_flips(torch, got, ref)
                if err > 1 or flips > MAX_FLIP_SHARE * got.numel():
                    raise AssertionError("{} {}: {} flipped bins (max distance {})".format(name, site, flips, err))
                detail = "{} of {} bins flipped by 1".format(flips, got.numel())
            else:
                err = float((got.float() - ref.float()).abs().max())
                if not torch.equal(got, ref):
                    raise AssertionError("{} {}: not bit-equal, max |diff| {}".format(name, site, err))
                detail = "bit-equal"
            extra = {}
            if name in ("K6", "K7", "K9"):
                listed = [sum(map(len, qtail.nonzero_blocks(node))) for node in (kargs[1], kargs[3])]
                extra["blocks_listed"] = listed
                extra["blocks_skipped"] = [9 * 16 - k for k in listed]
                detail += "; weight blocks skipped: dec4 {} of 144, dec5 {} of 144".format(*extra["blocks_skipped"])
            arg_sets = rotated(torch, kargs)
            ms = cuda_ms(torch, kernel, arg_sets, 20)
            dev_ms = device_ms(torch, kernel, arg_sets, 20)
            plain_ms = cuda_ms(torch, plain, arg_sets, 2)
            del arg_sets
            cost = site_work(name, kargs, got)
            extra["device_ms"] = dev_ms
            extra["tops"] = cost[1] / (dev_ms or ms) / 1e9
            bound_ms, bound_by = record(per_kernel, name, site, kargs[0].shape, err, ms, plain_ms, cost, **extra)
            peak = PEAK[cost[2]] / 1e12
            log("phase 3: {} {} {} -> {}: {}; kernel {:.4f} ms (events), {} (device), {:.1f} {} ({:.1%} of {:.0f}), "
                "plain {:.3f} ms, bound {:.4f} ms ({})".format(
                    name, site, tuple(kargs[0].shape), tuple(got.shape), detail, ms,
                    "not measured" if dev_ms is None else "{:.4f} ms".format(dev_ms), extra["tops"],
                    "TOP/s" if cost[2] == "int8" else "TFLOP/s", extra["tops"] / peak, peak, plain_ms, bound_ms,
                    bound_by))
    del checks, kargs, got, ref, feats
    torch.cuda.empty_cache()
    lap(marks, "phase 3")

    # ---- phase 4: the probes path (K2, K10) ------------------------------
    counted = wrappers()
    launches = {name: 0 for name in SOURCES}
    by_path = {"probes": run_probes(torch, device, seed, counted, per_kernel, smi)}
    for name, c in by_path["probes"].items():
        launches[name] += c
    torch.cuda.empty_cache()
    lap(marks, "phase 4")

    # ---- phase 5: predict on the card, along each path, then masks -------
    run_paths(torch, work, tiles, checkpoint, params, state, params_d, state_d, amaxes, counted, launches, by_path,
              smi)
    del params_d, state_d
    torch.cuda.empty_cache()
    lap(marks, "phase 5")

    # ---- phase 9: the vector tools, on phase 5's masks and a 16 x 16 block -
    # (run here, early in the process, where torch.profiler still records
    # every kernel)
    run_vector(torch, work, smi, masks_dir=os.path.join(work, "masks"))
    torch.cuda.empty_cache()
    lap(marks, "phase 9")

    # ---- phase 6: train ----------------------------------------------------
    train_card_vs_cpu(torch, seed)
    trained = configured_train_step(torch, seed, smi)["trained"]
    tool_checkpoint = train_tool(torch, work, seed, counted, launches, by_path, smi)
    lap(marks, "phase 6")

    # ---- phase 7: QAT and distillation -------------------------------------
    qat_distill_card_vs_cpu(torch, seed)
    by_path["qat-contract"] = configured_qat_distill_steps(torch, seed, smi, trained, counted)["launches"]
    del trained
    qat_distill_tools(torch, work, seed, tool_checkpoint, counted, by_path, smi)
    for path in ("qat-contract", "qat-predict"):
        for name, c in by_path[path].items():
            launches[name] += c
    lap(marks, "phase 7")

    # ---- phase 8: the fast family, in a process of its own -----------------
    torch.cuda.empty_cache()
    fast = run_phase_process(work, "--fast", "fast")
    for name, entry in fast["per_kernel"].items():
        for site in entry["sites"]:
            add_site(per_kernel, name, site)
    for name, c in fast["launches"].items():
        launches[name] += c
    by_path.update(fast["by_path"])
    lap(marks, "phase 8")

    # ---- phase 10: the README's workflow on the port alone -----------------
    torch.cuda.empty_cache()
    workflow = run_workflow(torch, work, seed, smi, counted)
    by_path["workflow"], by_path["workflow-export"] = workflow["launches"], workflow["export"]["launches"]
    for path in ("workflow", "workflow-export"):
        for name, c in by_path[path].items():
            launches[name] += c
    lap(marks, "phase 10")

    # ---- phases 11-14: DeepLabv3+, SegFormer, the per-channel calibration --
    # and the multi-device layer, each in a process of its own
    for phase, flag in ((11, "deeplab"), (12, "segformer"), (13, "pc"), (14, "mesh")):
        torch.cuda.empty_cache()
        family = run_phase_process(work, "--" + flag, flag)
        for name, entry in family["per_kernel"].items():
            for site in entry["sites"]:
                add_site(per_kernel, name, site)
        for name, c in family["launches"].items():
            launches[name] += c
        by_path.update(family["by_path"])
        lap(marks, "phase {}".format(phase))

    return [
        {"name": name, "route": "cuda", "source": SOURCES[name][0], "replaces": SOURCES[name][1],
         "launches": launches[name], "launches_by_path": {p: c[name] for p, c in by_path.items() if name in c},
         **per_kernel[name]}
        for name in SOURCES
    ]


def run_paths(torch, work, tiles, checkpoint, params, state, params_d, state_d, amaxes, counted, launches, by_path,
              smi):
    """Phase 5: `predict.main` along each of PATHS with every launch count
    set to 0 just before and read just after, each path's first batch
    through the kernels and the plain versions, the profiled run and
    `masks`. Adds each path's launches to `launches` and `by_path`."""
    from PIL import Image

    from robosat_tpu_torch.checkpoint import save_checkpoint, to_jax
    from robosat_tpu_torch.config import load_config, save_config
    from robosat_tpu_torch.data.loader import batches
    from robosat_tpu_torch.models import unet
    from robosat_tpu_torch.parallel.steps import make_int8_predict_step, make_predict_step
    from robosat_tpu_torch.tools import masks, predict

    tiles_dir = os.path.join(work, "tiles")
    base_config = load_config(os.path.join(ROOT, "config", "model-unet.toml"))
    # The int8 paths after the first quantize with phase 3's scales, which
    # the int8 run calibrates to again (reproducible, phase 3), through a
    # QAT checkpoint's qat_amaxes: their PNGs compare on equal scales, and
    # the full U-Net's float32 calibration (~10 s) runs once in `predict`.
    qat_checkpoint = os.path.join(work, "unet_qat.npz")
    save_checkpoint(qat_checkpoint, {"params": to_jax(params), "state": to_jax(state)},
                    meta={"epoch": 0, "qat_amaxes": [float(a) for a in amaxes]})
    pngs_by_path = {}
    for label, keys, flags, per_batch in PATHS:
        config = {**base_config, "common": {**base_config["common"], **keys}}
        model_toml = os.path.join(work, "model-{}.toml".format(label))
        save_config(config, model_toml)
        probs = os.path.join(work, "probs-{}".format(label))
        pargs = predict_args(work, tiles_dir, probs, model_toml, qat_checkpoint if label in QAT_PATHS else checkpoint,
                             **flags)
        tile_size = pargs.tile_size
        # The path's first loader batch, exactly as predict builds it.
        use_host_s2d = predict.host_s2d_input(config["common"], pargs)
        directory, _ = predict.input_directory(pargs, use_host_s2d)
        first = next(iter(batches(directory, predict.batch_items(pargs), workers=2)))
        first_tiles = batch_tiles(first, pargs.strip)
        n_batches = -(-len(directory) // predict.batch_items(pargs))
        steady_tiles = len(tiles) - len(first_tiles)

        for fn in counted.values():
            fn.launches = 0
        start = time.perf_counter()
        out = predict.main(pargs)
        wall = time.perf_counter() - start
        counts = {name: fn.launches for name, fn in counted.items()}
        expected = {name: per_batch.get(name, 0) * n_batches for name in counted}
        if counts != expected:
            raise AssertionError("[{}] launch counts {} != expected {} for {} batches".format(
                label, counts, expected, n_batches))
        if out["tiles"] != len(tiles):
            raise AssertionError("[{}] predict reported {} tiles, expected {}".format(label, out["tiles"], len(tiles)))
        by_path[label] = {name: c for name, c in counts.items() if c}
        for name, c in counts.items():
            launches[name] += c
        log("phase 5: [{}] predict wrote {} tiles in {:.2f} s; steady {:.2f} tiles/s over {} tiles ({:.3f} s) on {}; "
            "{} batches of {} x {}; launches {}".format(
                label, out["tiles"], wall, steady_tiles / out["steady_s"], steady_tiles, out["steady_s"], smi,
                n_batches, predict.batch_items(pargs), first.arrays[0].shape[1:], by_path[label]))

        for x, y, z in tiles:
            img = Image.open(os.path.join(probs, str(z), str(x), "{}.png".format(y)))
            img.load()
            if img.mode != "P" or img.size != (tile_size, tile_size):
                raise AssertionError("[{}] tile {}: {} {}".format(label, (x, y, z), img.mode, img.size))
        pngs = pngs_by_path[label] = read_pngs(probs, tiles)
        for other, held in COMPARED.get(label, ()):
            flips, err = u8_flips(torch, torch.from_numpy(pngs), torch.from_numpy(pngs_by_path[other]))
            if held and (err > 1 or flips > MAX_FLIP_SHARE * pngs.size):
                raise AssertionError("[{}] PNGs vs the {} run's: {} flipped pixels (max distance {})".format(
                    label, other, flips, err))
            log("phase 5: [{}] PNGs vs the {} run's{}: {} of {} pixels differ, max distance {}".format(
                label, other, "" if held else " (counted only: {})".format(NOT_HELD[label]), flips, pngs.size,
                err))
            if pargs.strip > 1:
                near, far = strip_edge_shares(pngs != pngs_by_path[other], tiles, pargs.strip)
                log("phase 5: [{}]   differing share within {} rows of a tile edge inside a strip {:.4%}, "
                    "elsewhere {:.4%}".format(label, EDGE_ROWS, near, far))

        # The first batch again, with the same weights and scales, through
        # the kernels and through the plain versions; the kernel path must
        # also reproduce the PNGs predict wrote for that batch.
        raw = first.arrays[0]
        if config["common"].get("int8", False):
            step, qt = make_int8_predict_step(
                unet, params_d, state_d, raw, overlap=pargs.overlap, fused_head=keys.get("fused_head", True),
                host_s2d=use_host_s2d, calib_percentile=99.8, calib_amaxes=amaxes,
                pallas_tail=keys.get("pallas_tail"))

            def run_step(plain=False, step=step, qt=qt, raw=raw):
                return step(qt, raw, plain=plain)
        else:
            float_step = make_predict_step(unet, overlap=pargs.overlap, compute_dtype=torch.bfloat16, fused_head=True,
                                           host_s2d=use_host_s2d)

            def run_step(plain=False, float_step=float_step, raw=raw):
                return float_step(params_d, state_d, raw, plain=plain)
        got = run_step()
        start_ev, end_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start_ev.record()
        ref = run_step(plain=True)
        end_ev.record()
        torch.cuda.synchronize()
        step_ms = cuda_ms(torch, run_step, [()], 5)
        flips, err = u8_flips(torch, got, ref)
        fine = fine_u8(got)
        if fine.shape != (raw.shape[0], pargs.strip * tile_size, tile_size) or err > 1 \
                or flips > MAX_FLIP_SHARE * got.numel():
            raise AssertionError("[{}] step {}: {} flipped bins vs the plain path (max distance {})".format(
                label, tuple(got.shape), flips, err))
        fine = fine.reshape(-1, tile_size, tile_size)[: len(first_tiles)]
        written = read_pngs(probs, first_tiles)
        if not np.array_equal(written, fine):
            raise AssertionError("[{}] predict's PNGs differ from the step's output on {} pixels".format(
                label, int((written != fine).sum())))
        log("phase 5: [{}] batch {} through the kernels vs the plain path: {} of {} bins flipped by 1; "
            "step {:.2f} ms with kernels, {:.2f} ms plain; PNGs match the kernel step".format(
                label, raw.shape, flips, got.numel(), step_ms, start_ev.elapsed_time(end_ev)))
        log_step_profile(torch, run_step, label, per_batch)
        del run_step, got, ref
        torch.cuda.empty_cache()

    # ---- phase 5: predict under --profile, then masks --------------------
    label, keys, flags, per_batch = PATHS[0]
    n_batches = -(-len(tiles) // BATCH)
    trace_dir = os.path.join(work, "trace")
    pargs = predict_args(work, tiles_dir, os.path.join(work, "probs-profiled"),
                         os.path.join(work, "model-{}.toml".format(label)), checkpoint, profile=trace_dir, **flags)
    for fn in counted.values():
        fn.launches = 0
    predict.main(pargs)
    counts = {name: fn.launches for name, fn in counted.items()}
    expected = {name: per_batch.get(name, 0) * n_batches for name in counted}
    if counts != expected:
        raise AssertionError("[profiled] launch counts {} != expected {}".format(counts, expected))
    for name, c in counts.items():
        launches[name] += c
    check_trace(trace_dir, n_batches)
    if not np.array_equal(read_pngs(pargs.probs, tiles), pngs_by_path[label]):
        raise AssertionError("[profiled] PNGs differ from the {} run's".format(label))

    masks_dir = os.path.join(work, "masks")
    start = time.perf_counter()
    masks.main(argparse.Namespace(masks=masks_dir, probs=[os.path.join(work, "probs-int8")], weights=None))
    wall = time.perf_counter() - start
    for x, y, z in tiles:
        mask = np.asarray(Image.open(os.path.join(masks_dir, str(z), str(x), "{}.png".format(y))))
        png = os.path.join(work, "probs-int8", str(z), str(x), "{}.png".format(y))
        want = masks.softvote([masks._load_probs(png)], axis=0).astype(np.uint8)
        if not np.array_equal(mask, want):
            raise AssertionError("masks: tile {} differs from softvote(_load_probs) on {} pixels".format(
                (x, y, z), int((mask != want).sum())))
    log("phase 5: [masks] {} masks from the int8 run's PNGs in {:.2f} s, each equal to softvote(_load_probs(png)) "
        "on the host; foreground share {:.4f}".format(
            len(tiles), wall, float(np.mean([np.asarray(Image.open(os.path.join(
                masks_dir, str(z), str(x), "{}.png".format(y)))) for x, y, z in tiles]))))



def learnable_batches(rng, steps, batch, size):
    """uint8 image and int64 mask batches: noise with brightened square
    blobs as class 1, so that the task is learnable (the blobs of
    tests/test_torch_train_parity.py, scaled with the side)."""
    out = []
    half = max(size * 10 // 64, 2)
    yy, xx = np.mgrid[0:size, 0:size]
    for _ in range(steps):
        images = rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8)
        masks = np.zeros((batch, size, size), np.int64)
        for b in range(batch):
            cy, cx = rng.integers(size // 4, size - size // 4, 2)
            blob = (np.abs(yy - cy) < half) & (np.abs(xx - cx) < half)
            masks[b][blob] = 1
            images[b][blob] = np.clip(images[b][blob].astype(np.int32) + 80, 0, 255).astype(np.uint8)
        out.append((images, masks))
    return out


def reference_style(torch, params, seed):
    """`params` with every conv kernel redrawn from N(0, 0.05^2), the scale
    of tests/test_torch_checkpoint.py's reference-layout weights, whose
    losses stay in the range where two faithful trajectories can be held
    to 5% (He-initialized full depth starts at losses of ~50)."""
    from robosat_tpu_torch.checkpoint import _map

    gen = torch.Generator().manual_seed(seed)
    return _map(params, lambda t: torch.randn(t.shape, generator=gen) * 0.05 if t.dim() == 4 else t.clone())


def cosine(torch, a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm() + 1e-30))


def leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def flat(torch, tensors):
    return torch.cat([t.detach().float().cpu().flatten() for t in tensors])


def assert_ulp_or_rtol(torch, what, got, want, rtol=1e-6, atol=0.0):
    """Each element of `got` within 1 ulp of `want`, or `rtol` relative, or
    `atol` absolute (float32 vectors on the host)."""
    differ = got != want
    g, w = got[differ], want[differ]
    ulps = (g.view(torch.int32).long() - w.view(torch.int32).long()).abs()
    err = (g.double() - w.double()).abs()
    bad = ~((ulps <= 1) | (err <= rtol * w.double().abs()) | (err <= atol))
    if bool(bad.any()):
        raise AssertionError("{}: {} of {} elements beyond 1 ulp, {} relative and {} absolute (max {})".format(
            what, int(bad.sum()), got.numel(), rtol, atol, float(err.max())))


def replay_adam_step(torch, optim, checkpoint, optimizer, before, opt_before, lr, what):
    """The card's Adam step just taken, replayed on the CPU: the port's Adam
    from the card's weights `before` and optimizer leaves `opt_before`
    (count and moments before the step) on the card's gradients gives the
    card's new moments within 1 ulp or 1e-6 relative, and its weights too
    or within 1e-6 * lr (the update, at most ~lr, one rounding apart where
    a weight near zero cancels)."""
    params = checkpoint._optimizer_params(optimizer)
    replay = [b.clone().requires_grad_(True) for b in before]
    cpu = checkpoint.leaves_to_opt_state(optim.Adam(replay, lr=lr), opt_before)
    for r, p in zip(replay, params):
        r.grad = None if p.grad is None else p.grad.detach().cpu()
    cpu.step()
    assert_ulp_or_rtol(torch, what + " weights", flat(torch, params), flat(torch, replay), atol=1e-6 * lr)
    got, want = checkpoint.opt_state_to_leaves(optimizer), checkpoint.opt_state_to_leaves(cpu)
    if int(got[0]) != int(want[0]):
        raise AssertionError("{}: count {} on the card, {} replayed".format(what, int(got[0]), int(want[0])))
    n = len(params)
    for name, lo, hi in (("mu", 1, 1 + n), ("nu", 1 + n, 1 + 2 * n)):
        assert_ulp_or_rtol(torch, "{} {}".format(what, name), flat(torch, map(torch.from_numpy, got[lo:hi])),
                           flat(torch, map(torch.from_numpy, want[lo:hi])))


def train_card_vs_cpu(torch, seed):
    """Phase 6a: the float32 train step (TF32 off) on the card and on the
    CPU, from the same weights on the same batches, per loss.

    Every card step is replayed on the CPU from the card's own weights,
    moments and gradients (`replay_adam_step`), so an optimizer or wiring
    fault that shows only on the card fails there. The two trajectories
    are held where faithful float32 runs stay together: the step-0 loss
    and gradients, steps 1-2's losses, bn1's statistics, and after step 1
    the update (weights minus the start), mu and nu by cosine over all 37M
    weights (TRAIN_UPDATE_FLOORS), the update also by its norm within 1%.
    Adam's first updates are ~lr * sign(grad), so wherever a gradient is
    near zero its sign, and that weight's update, follows the summation
    order of the backward: the weights cannot be held element by element,
    and after the last step the cosines are only printed."""
    from robosat_tpu_torch import checkpoint, optim
    from robosat_tpu_torch.checkpoint import from_jax, to_jax
    from robosat_tpu_torch.models import unet
    from robosat_tpu_torch.ops.losses import get_loss
    from robosat_tpu_torch.parallel.steps import make_train_step

    lr = 1e-4
    params, state = unet.init(seed)
    params = reference_style(torch, params, seed)
    batches = learnable_batches(np.random.default_rng(seed + 6), TRAIN_CHECK_STEPS, 2, 64)
    start = flat(torch, checkpoint.tree_leaves(params))
    for loss_name, weight in (("CrossEntropy", PARKING_WEIGHTS), ("Lovasz", None)):
        runs = {}
        for device in ("cpu", "cuda"):
            p, s = from_jax(to_jax(params), to_jax(state), device)
            optimizer = optim.adam(p, lr)
            step = make_train_step(unet, get_loss(loss_name), optimizer, weight=weight, augment=False)
            seconds = 0.0
            losses, grads, after = [], None, {}
            for i, (images, masks) in enumerate(batches):
                if device == "cuda":
                    before = [t.detach().to("cpu", copy=True) for t in checkpoint.tree_leaves(p)]
                    opt_before = [np.array(v) for v in checkpoint.opt_state_to_leaves(optimizer)]
                t0 = time.perf_counter()
                s, loss, _ = step(p, s, images, masks)
                losses.append(float(loss))
                seconds += time.perf_counter() - t0
                if grads is None:
                    grads = {path: leaf(p, path).grad.detach().cpu().clone() for path, _ in COSINE_FLOORS}
                if device == "cuda":
                    replay_adam_step(torch, optim, checkpoint, optimizer, before, opt_before, lr,
                                     "6a {} step {} replayed on the CPU".format(loss_name, i))
                if i in (0, len(batches) - 1):
                    leaves = checkpoint.opt_state_to_leaves(optimizer)
                    n = (len(leaves) - 1) // 2
                    after[i + 1] = {"update": flat(torch, checkpoint.tree_leaves(p)) - start,
                                    "mu": flat(torch, map(torch.from_numpy, leaves[1:1 + n])),
                                    "nu": flat(torch, map(torch.from_numpy, leaves[1 + n:]))}
            runs[device] = losses, grads, s, seconds, after
        (want, want_grads, want_state, cpu_s, want_after), (got, got_grads, got_state, card_s, got_after) = (
            runs["cpu"], runs["cuda"])
        if abs(got[0] - want[0]) > 1e-4 * abs(want[0]):
            raise AssertionError("6a {}: step-0 loss {} on the card, {} on the CPU".format(loss_name, got[0], want[0]))
        if any(abs(got[i] - want[i]) > 0.05 * abs(want[i]) for i in (1, 2)):
            raise AssertionError("6a {}: losses {} on the card, {} on the CPU".format(loss_name, got, want))
        cosines = {}
        for path, floor in COSINE_FLOORS:
            cosines["/".join(map(str, path))] = c = cosine(torch, got_grads[path], want_grads[path])
            if c < floor:
                raise AssertionError("6a {}: gradient cosine {} < {} at {}".format(loss_name, c, floor, path))
        bn_err = max(float((got_state["encoder"]["bn1"][k].cpu() - want_state["encoder"]["bn1"][k]).abs().max())
                     for k in ("mean", "var"))
        if bn_err > 5e-3:
            raise AssertionError("6a {}: bn1 running statistics differ by {}".format(loss_name, bn_err))
        agreement = {}
        for steps in sorted(got_after):
            got_v, want_v = got_after[steps], want_after[steps]
            agreement[steps] = {k: cosine(torch, got_v[k], want_v[k]) for k in TRAIN_UPDATE_FLOORS}
            agreement[steps]["norm ratio"] = float(got_v["update"].double().norm() / want_v["update"].double().norm())
        for k, floor in TRAIN_UPDATE_FLOORS.items():
            if agreement[1][k] < floor:
                raise AssertionError("6a {}: after step 1 the {} cosine card vs CPU is {} < {}".format(
                    loss_name, k, agreement[1][k], floor))
        if abs(agreement[1]["norm ratio"] - 1) > 0.01:
            raise AssertionError("6a {}: after step 1 the update's norm on the card is {} times the CPU's".format(
                loss_name, agreement[1]["norm ratio"]))
        log("phase 6: [6a] {} float32, 64 px, batch 2, {} steps: losses card {} CPU {}; step-0 cosines {}; bn1 "
            "running statistics within {:.2e}; every card step equals its Adam replayed on the CPU; card vs CPU "
            "after steps {} (held after 1): {}; {:.2f} s on the card, {:.2f} s on the CPU".format(
                loss_name, len(batches), ["{:.6f}".format(v) for v in got], ["{:.6f}".format(v) for v in want],
                {k: round(v, 7) for k, v in cosines.items()}, bn_err, sorted(agreement),
                {n: {k: round(v, 7) for k, v in a.items()} for n, a in agreement.items()}, card_s, cpu_s))


def configured_train_step(torch, seed, smi):
    """Phase 6b: config/model-unet.toml's train step as it stands (bf16,
    its loss, batch and image size, remat, augmentation on) from
    `unet.init`, TRAIN_STEPS steps on one learnable batch; then the device
    profile of PROFILE_STEPS more, and TIMED_STEPS with cuDNN's
    deterministic algorithms off for comparison. Returns the numbers."""
    from robosat_tpu_torch import optim
    from robosat_tpu_torch.checkpoint import from_jax, to_jax
    from robosat_tpu_torch.config import load_config
    from robosat_tpu_torch.models import unet
    from robosat_tpu_torch.ops.losses import get_loss
    from robosat_tpu_torch.parallel.steps import make_train_step

    config = load_config(os.path.join(ROOT, "config", "model-unet.toml"))
    common, opt = config["common"], config["opt"]
    batch, size = common["batch_size"], common["image_size"]
    dtype = torch.bfloat16 if common.get("bf16", False) else torch.float32
    weight = PARKING_WEIGHTS if opt["loss"] != "Lovasz" else None
    images, masks = learnable_batches(np.random.default_rng(seed + 7), 1, batch, size)[0]
    images, masks = torch.from_numpy(images).pin_memory(), torch.from_numpy(masks).pin_memory()
    params0, state0 = unet.init(seed)
    remat = common.get("remat", False)

    def attempt(remat):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params, state = from_jax(to_jax(params0), to_jax(state0), "cuda")
        step = make_train_step(unet, get_loss(opt["loss"]), optim.adam(params, opt["lr"]), weight=weight,
                               compute_dtype=dtype, remat=remat)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        losses, events = [], []
        for _ in range(TRAIN_STEPS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            state, loss, _ = step(params, state, images, masks, gen)
            end.record()
            losses.append(loss)
            events.append((start, end))
        torch.cuda.synchronize()
        return params, state, step, gen, [float(v) for v in losses], [a.elapsed_time(b) for a, b in events]

    try:
        params, state, step, gen, losses, step_ms = attempt(remat)
        oom = None
    except torch.cuda.OutOfMemoryError as exc:
        if remat:
            raise
        oom = str(exc).splitlines()[0][:160]
    if oom is not None:  # retried outside the handler, whose traceback holds the first attempt's tensors
        log("phase 6: [6b] batch {} at {} px does not fit without remat ({}); running remat = true".format(
            batch, size, oom))
        remat = True
        params, state, step, gen, losses, step_ms = attempt(remat)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError("6b: {} losses {}".format(opt["loss"], losses))
    median_ms = float(np.median(step_ms[2:]))
    log("phase 6: [6b] {} {} batch {} at {} px, remat {}, augmentation on, unet.init({}): {} losses {}".format(
        smi, str(dtype)[6:], batch, size, str(remat).lower(), seed, opt["loss"], ["{:.5f}".format(v) for v in losses]))
    log("phase 6: [6b] step ms by CUDA events {}; median over steps 3-{} {:.2f} ms = {:.1f} images/s; "
        "max_memory_allocated {:.2f} GB".format(["{:.2f}".format(v) for v in step_ms], TRAIN_STEPS, median_ms,
                                                batch / median_ms * 1e3, peak_gb))

    holder = {"state": state}

    def one_step():
        holder["state"], _, _ = step(params, holder["state"], images, masks, gen)

    idle = log_train_profile(torch, "phase 6: [6b]", one_step, TRAIN_KERNEL_GROUPS)

    torch.backends.cudnn.deterministic = False
    try:
        nondet = []
        for _ in range(TIMED_STEPS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            one_step()
            end.record()
            nondet.append((start, end))
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = True
    nondet_ms = [a.elapsed_time(b) for a, b in nondet]
    log("phase 6: [6b] cudnn.deterministic = False (for comparison only): step ms {}; median of the last {} {:.2f} ms "
        "against {:.2f} with the deterministic algorithms".format(
            ["{:.2f}".format(v) for v in nondet_ms], TIMED_STEPS - 1, float(np.median(nondet_ms[1:])), median_ms))
    trained = {"params": params, "state": holder["state"]}
    del params, state, holder, step
    torch.cuda.empty_cache()
    return {"median_ms": median_ms, "images_per_s": batch / median_ms * 1e3, "peak_gb": peak_gb, "idle": idle,
            "remat": remat, "losses": losses, "nondeterministic_ms": float(np.median(nondet_ms[1:])),
            "trained": trained}


def log_train_profile(torch, prefix, one_step, kernel_groups):
    """torch.profiler over PROFILE_STEPS calls of one_step(): the wall time
    a step, the kernels' time, the device idle share, the 8 costliest
    kernels and the kernels by kind (`kernel_groups`, first match wins),
    each logged after `prefix`; returns the idle share (None when the
    profiler records no kernel time)."""
    wall_ms, rows, _ = profile_kernels(torch, one_step, PROFILE_STEPS)
    if not rows:
        log("{} the profiler recorded no kernel time (idle share not measured)".format(prefix))
        return None
    busy = sum(r[0] for r in rows)
    idle = 1 - busy / wall_ms
    log("{} profile of {} steps: {:.2f} ms wall a step (profiled), {:.2f} ms of kernels, device idle {:.1%}".format(
        prefix, PROFILE_STEPS, wall_ms, busy, idle))
    for ms, count, key in rows[:8]:
        log("{}   {:8.3f} ms/step {:4d} launches  {}".format(prefix, ms, count, key[:110]))
    groups = {}
    for ms, count, key in rows:
        group = next((g for g, pattern in kernel_groups if pattern.search(key)), "other elementwise")
        total, launched = groups.get(group, (0.0, 0))
        groups[group] = (total + ms, launched + count)
    log("{}   by kind (ms/step, launches/step): {}".format(
        prefix, {g: (round(ms, 3), n) for g, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0])}))
    return idle


def write_training_set(root, seed):
    """A slippy-map training set of 512-px tiles at z18: TRAIN_TILES_SIDE^2
    training and VAL_TILES_SIDE^2 validation tiles, RGB images with
    learnable blobs and "P" labels (class 1 the blobs)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for split, side, x0 in (("training", TRAIN_TILES_SIDE, 69620), ("validation", VAL_TILES_SIDE, 69700)):
        (batch,) = learnable_batches(rng, 1, side * side, TILE)
        for i in range(side * side):
            x, y = x0 + i // side, 104940 + i % side
            label = Image.fromarray(batch[1][i].astype(np.uint8), mode="P")
            label.putpalette([0, 0, 0, 255, 255, 255])
            for sub, img in (("images", Image.fromarray(batch[0][i])), ("labels", label)):
                os.makedirs(os.path.join(root, split, sub, "18", str(x)), exist_ok=True)
                img.save(os.path.join(root, split, sub, "18", str(x), "{}.png".format(y)), compress_level=1)


def train_tool(torch, work, seed, counted, launches, by_path, smi):
    """Phase 6c: `train.main` in-process for epoch 1, `--resume` to epoch
    2, then int8 `predict` (TRAINED_CALIBRATION) from the trained checkpoint over
    the training tiles, its launches counted; returns the epoch-2
    checkpoint."""
    from robosat_tpu_torch.checkpoint import load_checkpoint
    from robosat_tpu_torch.config import load_config, save_config
    from robosat_tpu_torch.tools import train

    root = os.path.join(work, "slippy")
    start = time.perf_counter()
    write_training_set(root, seed)
    log("phase 6: [6c] wrote {} training and {} validation tiles of {} px in {:.2f} s".format(
        TRAIN_TILES_SIDE ** 2, VAL_TILES_SIDE ** 2, TILE, time.perf_counter() - start))
    base = load_config(os.path.join(ROOT, "config", "model-unet.toml"))
    ckpt_dir = os.path.join(work, "train-checkpoints")
    dataset = load_config(os.path.join(ROOT, "config", "dataset-parking.toml"))
    dataset["common"]["dataset"] = root
    dataset_toml = os.path.join(work, "dataset-train.toml")
    save_config(dataset, dataset_toml)
    outs = []
    for epochs in (1, 2):
        config = {**base, "common": {**base["common"], "batch_size": TOOL_BATCH, "checkpoint": ckpt_dir},
                  "opt": {**base["opt"], "epochs": epochs}}
        model_toml = os.path.join(work, "model-train-{}.toml".format(epochs))
        save_config(config, model_toml)
        resume = os.path.join(ckpt_dir, "checkpoint-00001-of-00001.npz") if epochs == 2 else None
        args = argparse.Namespace(model=model_toml, dataset=dataset_toml, checkpoint=resume, resume=resume is not None,
                                  workers=4, profile=None)
        start = time.perf_counter()
        outs.append(train.main(args))
        log("phase 6: [6c] train epochs {} -> {}: {} steps in {:.2f} s (resumed at count {}, now {})".format(
            outs[-1]["resume_epoch"], epochs, outs[-1]["steps"], time.perf_counter() - start,
            outs[-1]["restored_count"], outs[-1]["count"]))
    steps = TRAIN_TILES_SIDE ** 2 // TOOL_BATCH
    if (outs[0]["steps"], outs[0]["count"]) != (steps, steps) or outs[1]["restored_count"] != outs[0]["count"] \
            or outs[1]["count"] != 2 * steps:
        raise AssertionError("6c: step counts {} / {}".format(outs[0], outs[1]))
    files = sorted(os.listdir(ckpt_dir))
    for name in ("checkpoint-00001-of-00001.npz", "checkpoint-00002-of-00002.npz"):
        trees, meta = load_checkpoint(os.path.join(ckpt_dir, name))
        count = int(trees["opt_state"][0])
        if name not in files or count != steps * meta["epoch"]:
            raise AssertionError("6c: {} (files {}), opt_state count {}".format(name, files, count))
        log("phase 6: [6c] {}: {:.1f} MB, meta {}, opt_state count {}, {} leaves".format(
            name, os.path.getsize(os.path.join(ckpt_dir, name)) / 1e6, meta, count, len(trees["opt_state"])))
    log("phase 6: [6c] files {}; matplotlib {}".format(
        files, "present (history charts written)" if any(f.startswith("history-") for f in files) else "missing"))
    for line in open(os.path.join(ckpt_dir, "log")).read().splitlines():
        log("phase 6: [6c] log | {}".format(line))

    checkpoint = tool_checkpoint_path(work)
    counts, pngs, wall, n_batches = predict_split_tiles(root, os.path.join(work, "probs-trained"), checkpoint,
                                                        counted, "6c predict", calibration=TRAINED_CALIBRATION)
    by_path["train-predict"] = counts
    for name, c in counts.items():
        launches[name] += c
    log("phase 6: [6c] predict (int8, amax calibration) from checkpoint-00002-of-00002.npz: {} PNGs in {:.2f} s on {}; "
        "launches {} ({} batches)".format(pngs, wall, smi, counts, n_batches))
    return checkpoint


def predict_split_tiles(root, probs, checkpoint, counted, label, model_toml=None, per_batch=None,
                        split="training", tiles=TRAIN_TILES_SIDE ** 2, calibration=None):
    """int8 `predict` as configured (config/model-unet.toml, or `model_toml`;
    through a copy with int8_calibration = `calibration` where one is given)
    over the `tiles` tiles of `split` of the dataset at `root` from
    `checkpoint`, every launch count set to 0 just before and read just
    after: one palette PNG of TILE px per tile, and per batch the launches
    of `per_batch` (default the U-Net's: 13 K3, 3 K4, 5 K5 and 1 K6).
    Returns (the nonzero launch counts, PNGs, seconds, batches)."""
    from PIL import Image

    from robosat_tpu_torch.config import load_config, save_config
    from robosat_tpu_torch.tools import predict

    model_toml = model_toml or os.path.join(ROOT, "config", "model-unet.toml")
    if calibration is not None:
        config = load_config(model_toml)
        config["common"]["int8_calibration"] = calibration
        model_toml = probs.rstrip(os.sep) + "-model.toml"
        save_config(config, model_toml)
    pargs = predict_args(None, os.path.join(root, split, "images"), probs, model_toml, checkpoint)
    n_batches = -(-tiles // BATCH)
    for fn in counted.values():
        fn.launches = 0
    start = time.perf_counter()
    out = predict.main(pargs)
    wall = time.perf_counter() - start
    counts = {name: fn.launches for name, fn in counted.items()}
    expected = {name: (per_batch or PATHS[0][3]).get(name, 0) * n_batches for name in counted}
    if counts != expected or out["tiles"] != tiles:
        raise AssertionError("{}: {} tiles, launch counts {} != expected {}".format(label, out["tiles"], counts,
                                                                                   expected))
    pngs = 0
    for dirpath, _, names in os.walk(probs):
        for name in names:
            img = Image.open(os.path.join(dirpath, name))
            img.load()
            if img.mode != "P" or img.size != (TILE, TILE):
                raise AssertionError("{}: {} is {} {}".format(label, name, img.mode, img.size))
            pngs += 1
    if pngs != tiles:
        raise AssertionError("{}: {} PNGs for {} tiles".format(label, pngs, tiles))
    return {name: c for name, c in counts.items() if c}, pngs, wall, n_batches


def exact_var(torch, state):
    """A copy of a BN state tree with var + eps == 1 exactly in float32:
    the fold's rsqrt is then exact on every device, so the folded kernels'
    fake-quant grids cannot part by a last-bit rsqrt."""
    if isinstance(state, dict):
        return {k: torch.full_like(v, float(np.float32(1.0) - np.float32(1e-5))) if k == "var" else exact_var(torch, v)
                for k, v in state.items()}
    if isinstance(state, list):
        return [exact_var(torch, v) for v in state]
    return state.clone()


def forcing_fake_quant(torch, real, taps):
    """A stand-in for `fake_quant_act` (`real`): with `taps` None it records
    each site's input into `.recorded`; otherwise site i quantizes
    `taps[i]` in place of its input (the value; the gradient passes
    straight to the input) and appends |input - taps[i]| max over
    |taps[i]| max to `.errs`. Free-running, two devices' fake-quant
    forwards part: a bin flipped by float summation order at one site
    flips more at every later one."""

    class Forced(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, forced):
            return forced

        @staticmethod
        def backward(ctx, grad):
            return grad, None

    def fake_quant_act(x, scale):
        if taps is None:
            fake_quant_act.recorded.append(x.detach().cpu().clone())
            return real(x, scale)
        want = taps[len(fake_quant_act.errs)].to(x.device, x.dtype)
        fake_quant_act.errs.append(float((x.detach() - want).abs().max() / want.abs().max()))
        return real(Forced.apply(x, want), scale)

    fake_quant_act.recorded, fake_quant_act.errs = [], []
    return fake_quant_act


def card_and_cpu_runs(torch, label, params, state, batches, lr, make_step, extra=None, force=False):
    """The step `make_step(optimizer)` from the same weights on the same
    batches, on the CPU and then on the card, each card step replayed on
    the CPU (`replay_adam_step`); `extra(device)` gives the arguments the
    step takes before the batch (the teacher). With `force` each step's
    forward records every site's fake-quant input on the CPU and the card
    quantizes those (`forcing_fake_quant`). Returns {device: {"losses",
    "grads" (step 0's, by leaf, on the host), "state", "state_in",
    "after1" (update, mu, nu after step 1), "errs" (the card's forcing, per
    step)}}."""
    from robosat_tpu_torch import checkpoint, optim
    from robosat_tpu_torch.checkpoint import from_jax, to_jax
    from robosat_tpu_torch.models import int8 as q8

    start = flat(torch, checkpoint.tree_leaves(params))
    real = q8.fake_quant_act
    runs, taps = {}, []
    for device in ("cpu", "cuda"):
        p, s = from_jax(to_jax(params), to_jax(state), device)
        run = {"losses": [], "state_in": s, "errs": []}
        args = extra(device) if extra else ()
        optimizer = optim.adam(p, lr)
        step = make_step(optimizer)
        for i, (images, masks) in enumerate(batches):
            if device == "cuda":
                before = [t.detach().to("cpu", copy=True) for t in checkpoint.tree_leaves(p)]
                opt_before = [np.array(v) for v in checkpoint.opt_state_to_leaves(optimizer)]
            forcing = forcing_fake_quant(torch, real, taps[i] if device == "cuda" else None) if force else real
            q8.fake_quant_act = forcing
            try:
                s, loss, _ = step(p, s, *args, images, masks)
            finally:
                q8.fake_quant_act = real
            run["losses"].append(float(loss))
            if force and device == "cpu":
                taps.append(forcing.recorded)
            elif force:
                run["errs"].append(max(forcing.errs) if len(forcing.errs) == len(taps[i]) else None)
            if i == 0:
                run["grads"] = [torch.zeros(t.shape) if t.grad is None else t.grad.detach().cpu().clone()
                                for t in checkpoint.tree_leaves(p)]
            if device == "cuda":
                replay_adam_step(torch, optim, checkpoint, optimizer, before, opt_before, lr,
                                 "7a {} step {} replayed on the CPU".format(label, i))
            if i == 0:
                leaves = checkpoint.opt_state_to_leaves(optimizer)
                n = (len(leaves) - 1) // 2
                run["after1"] = {"update": flat(torch, checkpoint.tree_leaves(p)) - start,
                                 "mu": flat(torch, map(torch.from_numpy, leaves[1:1 + n])),
                                 "nu": flat(torch, map(torch.from_numpy, leaves[1 + n:]))}
        run["state"] = s
        runs[device] = run
    return runs


def qat_distill_card_vs_cpu(torch, seed):
    """Phase 7a: the QAT step (Lovasz) and the distillation step
    (CrossEntropy with dataset-parking's weights, alpha 0.9, T 2) in
    float32 (TF32 off) at 64 px, batch 2, augmentation off, 3 steps each on
    the card and on the CPU from the same weights (N(0, 0.05^2) kernels as
    6a, BN var + eps == 1), each card step equal to its Adam replayed on
    the CPU.

    QAT: the scales of a 99.8-percentile CPU calibration on the first
    batch. Every card step quantizes the CPU step's site inputs
    (`forcing_fake_quant`): free, the two forwards part at flipped bins
    (the port against the JAX package on the CPU: logits ~1% apart on
    average, gradient cosines 0.86-0.99999; a first chip run forcing step
    0 only had step 2's loss 12.5% from the CPU's). Held, from the CPU
    proxy (tests/test_torch_port_qat.py, forced: site inputs 1.7e-6, loss
    7.8e-7 relative, cosines >= 0.9999996; the update after step 1 at
    cosine 0.9997, forced steps 1-2 within 7e-7): step 0's site inputs
    within 1e-5 of their largest, its loss within 1e-4,
    tests/test_torch_train_parity.py's gradient cosine floors as in 6a (the
    least over all leaves printed: 0.99994 in a chip run, where port
    against JAX on the CPU gave 0.9999996), steps 1-2 within 1e-3, the
    update after step 1 at cosine >= 0.98 with its norm within 1%, and the
    BN state the step was given, unchanged bit for bit, on both devices.

    Distillation: the teacher the same layout from another seed, folded
    once on each device. Held as 6a holds the train step: step-0 loss
    within 1e-4, tests/test_torch_train_parity.py's gradient cosine
    floors, steps 1-2 within 5%, bn1's statistics within 5e-3, and after
    step 1 TRAIN_UPDATE_FLOORS with the update's norm within 1% (the port
    against the JAX package on the CPU: 2.7e-5, 0.1%, update cosine
    0.9949)."""
    from robosat_tpu_torch.checkpoint import from_jax, to_jax, tree_leaves
    from robosat_tpu_torch.models import int8 as q8
    from robosat_tpu_torch.models import unet
    from robosat_tpu_torch.ops.augment import normalize
    from robosat_tpu_torch.ops.losses import get_loss
    from robosat_tpu_torch.parallel.steps import make_distill_train_step, make_qat_train_step

    lr = 1e-4
    params, state = unet.init(seed + 1)
    params, state = reference_style(torch, params, seed + 1), exact_var(torch, state)
    batches = learnable_batches(np.random.default_rng(seed + 8), TRAIN_CHECK_STEPS, 2, 64)
    with torch.no_grad():
        scales = list(q8.scales_from_amaxes(q8.calibration_amaxes(
            unet.fold(params, state), normalize(torch.from_numpy(batches[0][0])), percentile=99.8)))
    t_params, t_state = unet.init(seed + 2)
    t_params, t_state = reference_style(torch, t_params, seed + 2), exact_var(torch, t_state)

    def teacher_on(device):
        p, s = from_jax(to_jax(t_params), to_jax(t_state), device)
        with torch.no_grad():
            return (unet.fold(p, s),)

    cases = (
        ("QAT", lambda opt: make_qat_train_step(unet, get_loss("Lovasz"), opt, scales, augment=False), None, True),
        ("distillation", lambda opt: make_distill_train_step(unet, unet, get_loss("CrossEntropy"), opt,
                                                             weight=PARKING_WEIGHTS, augment=False), teacher_on,
         False),
    )
    for label, make_step, extra, qat in cases:
        start = time.perf_counter()
        runs = card_and_cpu_runs(torch, label, params, state, batches, lr, make_step, extra, force=qat)
        want, got = runs["cpu"], runs["cuda"]
        losses, want_losses = got["losses"], want["losses"]
        leaf_cosines = [cosine(torch, a, b) for a, b in zip(got["grads"], want["grads"]) if float(b.norm()) > 0]
        paths = {"/".join(map(str, path)): cosine(torch, leaf_grad(got, params, path), leaf_grad(want, params, path))
                 for path, _ in COSINE_FLOORS}
        agreement = {k: cosine(torch, got["after1"][k], want["after1"][k]) for k in ("update", "mu", "nu")}
        ratio = float(got["after1"]["update"].double().norm() / want["after1"]["update"].double().norm())
        bn_err = max(float((got["state"]["encoder"]["bn1"][k].cpu() - want["state"]["encoder"]["bn1"][k]).abs().max())
                     for k in ("mean", "var"))
        log("phase 7: [7a] {} float32, 64 px, batch 2, {} steps: losses card {} CPU {}; {}step-0 gradient cosines "
            "{} (min over {} leaves {:.8f}); every card step equals its Adam replayed on the CPU; after step 1 "
            "{} (update norm ratio {:.7f}); bn1 statistics within {:.2e}; {:.2f} s".format(
                label, len(batches), ["{:.6f}".format(v) for v in losses], ["{:.6f}".format(v) for v in want_losses],
                "site inputs on the card within {} of the CPU's by step (each forced to the CPU's); ".format(
                    got["errs"]) if qat else "", {k: round(v, 7) for k, v in paths.items()}, len(leaf_cosines),
                min(leaf_cosines), {k: round(v, 7) for k, v in agreement.items()}, ratio, bn_err,
                time.perf_counter() - start))
        failed = []
        if abs(losses[0] - want_losses[0]) > 1e-4 * abs(want_losses[0]):
            failed.append("step-0 loss")
        if any(abs(losses[i] - want_losses[i]) > (1e-3 if qat else 0.05) * abs(want_losses[i]) for i in (1, 2)):
            failed.append("losses of steps 1-2")
        failed += ["gradient cosine at " + path for (path, floor), (_, c) in zip(COSINE_FLOORS, paths.items())
                   if c < floor]
        failed += ["after step 1 the {} cosine".format(k) for k, floor in
                   ({"update": 0.98} if qat else TRAIN_UPDATE_FLOORS).items() if agreement[k] < floor]
        if abs(ratio - 1) > 0.01:
            failed.append("the update's norm after step 1")
        if qat:
            if None in got["errs"] or got["errs"][0] > 1e-5:
                failed.append("step-0 site inputs")
            for run in (got, want):
                if run["state"] is not run["state_in"] or any(
                        not torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))
                        for a, b in zip(tree_leaves(run["state"]), tree_leaves(state))):
                    failed.append("the BN state changed")
        elif bn_err > 5e-3:
            failed.append("bn1 running statistics")
        if failed:
            raise AssertionError("7a {}: {} (see the line above)".format(label, ", ".join(failed)))
        if qat:
            log("phase 7: [7a] QAT: the BN state unchanged bit for bit on both devices")


def leaf_grad(run, params, path):
    """Step 0's gradient of the leaf at `path` in a card_and_cpu_runs run."""
    from robosat_tpu_torch.checkpoint import tree_leaves

    target = leaf(params, path)
    return next(g for t, g in zip(tree_leaves(params), run["grads"]) if t is target)


def configured_qat_distill_steps(torch, seed, smi, trained, counted):
    """Phase 7b: config/model-unet.toml's QAT and distillation steps as it
    stands (bf16, its loss, batch and image size, augmentation on), 10
    steps each on 6b's batch: QAT from 6b's trained weights with the
    scales of the config's calibration on that batch; distillation of a
    student from `unet.init` by 6b's weights, folded once. For each: the
    losses (finite, the last below the first), the median step by CUDA
    events over steps 3-10, images/s, peak memory, and a profile of
    PROFILE_STEPS more (idle share, kernels by kind). Then the QAT contract
    at full width: on 8 of the batch's images and the same scales, the
    bf16 fake-quant logits of the finetuned weights against the int8
    logits of K3/K4/K5 (`apply_features_int8_to_dec3`, fine stem), K7, the
    depth-to-space and the final 1x1 conv, every launch count set to 0
    just before and read just after (13 K3, 3 K4, 5 K5, 1 K7). Returns the
    numbers and the contract's launches."""
    from robosat_tpu_torch import optim
    from robosat_tpu_torch.checkpoint import from_jax, to_jax
    from robosat_tpu_torch.config import load_config
    from robosat_tpu_torch.models import int8 as q8
    from robosat_tpu_torch.models import qtail, unet
    from robosat_tpu_torch.models.layers import depth_to_space2
    from robosat_tpu_torch.ops.augment import normalize
    from robosat_tpu_torch.ops.losses import get_loss
    from robosat_tpu_torch.parallel.steps import make_distill_train_step, make_qat_train_step

    config = load_config(os.path.join(ROOT, "config", "model-unet.toml"))
    common, opt = config["common"], config["opt"]
    batch, size = common["batch_size"], common["image_size"]
    dtype = torch.bfloat16 if common.get("bf16", False) else torch.float32
    weight = PARKING_WEIGHTS if opt["loss"] != "Lovasz" else None
    images, masks = learnable_batches(np.random.default_rng(seed + 7), 1, batch, size)[0]
    images, masks = torch.from_numpy(images).pin_memory(), torch.from_numpy(masks).pin_memory()
    calibration = common.get("int8_calibration", 99.8)
    with torch.no_grad():
        amaxes = q8.calibration_amaxes(unet.fold(trained["params"], trained["state"]),
                                       normalize(images.cuda()), percentile=q8.calibration_spec(calibration))
    scales = list(q8.scales_from_amaxes(amaxes))
    with torch.no_grad():
        teacher_folded = unet.fold(trained["params"], trained["state"])
    results = {}

    def timed(label, params, state, step, extra):
        results[label], state = time_train_steps(torch, "phase 7: [7b {}]".format(label), step, params, state, extra,
                                                 images, masks, seed, opt["loss"], dtype, QAT_KERNEL_GROUPS, smi)
        return state

    # QAT from the trained weights; batch norm stays frozen.
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, state = from_jax(to_jax(trained["params"]), to_jax(trained["state"]), "cuda")
    step = make_qat_train_step(unet, get_loss(opt["loss"]), optim.adam(params, opt["lr"]), scales, weight=weight,
                               compute_dtype=dtype)
    if timed("QAT", params, state, step, ()) is not state:
        raise AssertionError("7b QAT: the step did not return the state it was given")
    del step

    # The QAT contract at full width, on the finetuned weights.
    x = normalize(images[:BATCH].cuda()).to(torch.bfloat16)
    with torch.no_grad():
        fq = unet.apply_logits_fake_quant(params, state, scales, x).float()
        qtree = q8.quantize_unet_folded(unet.fold(params, state))
        for fn in counted.values():
            fn.launches = 0
        dec3, s4, s5 = q8.apply_features_int8_to_dec3(qtree, scales, x)
        feats = qtail.fused_tail_features(dec3, qtree["dec4"], s4, qtree["dec5"], s5)
        int8 = unet.final_logits(qtree["final"], depth_to_space2(feats)).float()
        torch.cuda.synchronize()
    counts = {name: fn.launches for name, fn in counted.items()}
    expected = {name: {"K3": 13, "K4": 3, "K5": 5, "K7": 1}.get(name, 0) for name in counted}
    if counts != expected:
        raise AssertionError("7b QAT contract: launch counts {} != expected {}".format(counts, expected))
    scale = float(int8.abs().max())
    mean, worst = float((fq - int8).abs().mean()) / scale, float((fq - int8).abs().max()) / scale
    agree = float(((fq[..., 1] > fq[..., 0]) == (int8[..., 1] > int8[..., 0])).float().mean())
    log("phase 7: [7b QAT] contract on {} images of {} px: bf16 fake-quant logits vs int8 (K3/K4/K5/K7 launches "
        "{}): mean |diff| {:.5f}, max {:.5f} of the int8 logits' max {:.3f}; decisions agree on {:.5%} of pixels "
        "(bound: mean < {}, max < {}, agreement > {})".format(
            BATCH, size, {k: c for k, c in counts.items() if c}, mean, worst, scale, agree, *QAT_CONTRACT))
    if not (mean < QAT_CONTRACT[0] and worst < QAT_CONTRACT[1] and agree > QAT_CONTRACT[2]):
        raise AssertionError("7b QAT contract: mean {}, max {}, agreement {} outside {}".format(
            mean, worst, agree, QAT_CONTRACT))
    results["QAT"]["contract"] = {"mean": mean, "max": worst, "agreement": agree}
    del params, state, qtree, x, fq, int8, dec3, feats

    # Distillation of a fresh student by the trained weights.
    params0, state0 = unet.init(seed)
    remat = common.get("remat", False)

    def attempt(remat):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params, state = from_jax(to_jax(params0), to_jax(state0), "cuda")
        step = make_distill_train_step(unet, unet, get_loss(opt["loss"]), optim.adam(params, opt["lr"]),
                                       weight=weight, compute_dtype=dtype, remat=remat)
        timed("distillation", params, state, step, (teacher_folded,))

    try:
        attempt(remat)
        oom = None
    except torch.cuda.OutOfMemoryError as exc:
        if remat:
            raise
        oom = str(exc).splitlines()[0][:160]
    if oom is not None:  # retried outside the handler, whose traceback holds the first attempt's tensors
        log("phase 7: [7b distillation] batch {} at {} px does not fit without remat ({}); running remat = "
            "true".format(batch, size, oom))
        remat = True
        attempt(remat)
    results["distillation"]["remat"] = remat
    del teacher_folded
    torch.cuda.empty_cache()
    results["launches"] = {k: c for k, c in counts.items() if c}
    return results


def qat_distill_tools(torch, work, seed, tool_checkpoint, counted, by_path, smi):
    """Phase 7c: on 6c's dataset, `train --qat` for one epoch from 6c's
    checkpoint, `train --teacher` (that checkpoint) for one epoch from
    `unet.init`, each through a TOML copy with batch TOOL_BATCH; then int8
    `predict` as configured from the QAT checkpoint over the training tiles,
    which must quantize with the checkpoint's qat_amaxes and calibrate
    nothing, with 13 K3, 3 K4, 5 K5 and 1 K6 launches a batch."""
    from robosat_tpu_torch.checkpoint import load_checkpoint, tree_leaves
    from robosat_tpu_torch.config import load_config, save_config
    from robosat_tpu_torch.models import int8 as q8
    from robosat_tpu_torch.tools import predict, train

    root = os.path.join(work, "slippy")
    base = load_config(os.path.join(ROOT, "config", "model-unet.toml"))
    dataset_toml = os.path.join(work, "dataset-train.toml")
    steps = TRAIN_TILES_SIDE ** 2 // TOOL_BATCH
    checkpoints = {}
    for label, flags in (("qat", {"qat": True, "checkpoint": tool_checkpoint}), ("teacher", {"teacher": tool_checkpoint})):
        ckpt_dir = os.path.join(work, "train-{}".format(label))
        config = {**base, "common": {**base["common"], "batch_size": TOOL_BATCH, "checkpoint": ckpt_dir},
                  "opt": {**base["opt"], "epochs": 1}}
        model_toml = os.path.join(work, "model-train-{}.toml".format(label))
        save_config(config, model_toml)
        args = argparse.Namespace(model=model_toml, dataset=dataset_toml, checkpoint=None, resume=False, workers=4,
                                  profile=None, teacher=None, teacher_model=None, distill_alpha=0.9, distill_temp=2.0,
                                  qat=False)
        for key, value in flags.items():
            setattr(args, key, value)
        start = time.perf_counter()
        out = train.main(args)
        wall = time.perf_counter() - start
        checkpoints[label] = os.path.join(ckpt_dir, "checkpoint-00001-of-00001.npz")
        trees, meta = load_checkpoint(checkpoints[label])
        lines = open(os.path.join(ckpt_dir, "log")).read().splitlines()
        want_line = ("QAT finetune: 59 int8 sites, int8_calibration = {} (frozen)".format(
            base["common"].get("int8_calibration", 99.8)) if label == "qat" else
            "Distilling from: {} (alpha 0.9, T 2.0)".format(tool_checkpoint))
        if (out["steps"], out["count"], int(trees["opt_state"][0])) != (steps, steps, steps) or want_line not in lines \
                or (label == "qat") != ("qat_amaxes" in meta):
            raise AssertionError("7c {}: steps {}, count {}, meta {}, log {}".format(
                label, out["steps"], out["count"], sorted(meta), lines))
        if label == "qat":
            if len(meta["qat_amaxes"]) != 59 or not all(a > 0 and math.isfinite(a) for a in meta["qat_amaxes"]):
                raise AssertionError("7c qat: qat_amaxes {}".format(meta["qat_amaxes"]))
            trained_state = load_checkpoint(tool_checkpoint)[0]["state"]
            for a, b in zip(tree_leaves(trees["state"]), tree_leaves(trained_state)):
                if not np.array_equal(a.view(np.int32), b.view(np.int32)):
                    raise AssertionError("7c qat: the checkpoint's BN state differs from 6c's")
        log("phase 7: [7c] train {}: {} steps in {:.2f} s on {}; meta {}; log | {}".format(
            "--qat" if label == "qat" else "--teacher", out["steps"], wall, smi,
            {k: (v if k != "qat_amaxes" else "{} values".format(len(v))) for k, v in meta.items()}, want_line))

    qat_amaxes = load_checkpoint(checkpoints["qat"])[1]["qat_amaxes"]
    seen = {"calibrations": 0, "calib_amaxes": None}
    real_calibration, real_step = q8.calibration_amaxes, predict.make_int8_predict_step

    def calibration(*args, **kwargs):
        seen["calibrations"] += 1
        return real_calibration(*args, **kwargs)

    def int8_step(*args, **kwargs):
        seen["calib_amaxes"] = kwargs.get("calib_amaxes")
        return real_step(*args, **kwargs)

    q8.calibration_amaxes, predict.make_int8_predict_step = calibration, int8_step
    try:
        counts, pngs, wall, n_batches = predict_split_tiles(root, os.path.join(work, "probs-qat"),
                                                            checkpoints["qat"], counted, "7c predict")
    finally:
        q8.calibration_amaxes, predict.make_int8_predict_step = real_calibration, real_step
    if seen["calibrations"] or seen["calib_amaxes"] is None or \
            not np.array_equal(np.asarray(seen["calib_amaxes"], np.float64), np.asarray(qat_amaxes, np.float64)):
        raise AssertionError("7c predict: {} calibrations, scales from {}".format(
            seen["calibrations"], "a calibration" if seen["calib_amaxes"] is None else "other amaxes"))
    by_path["qat-predict"] = counts
    log("phase 7: [7c] predict (int8 as configured) from the QAT checkpoint: quantized with its 59 qat_amaxes, "
        "no calibration; {} PNGs in {:.2f} s on {}; launches {} ({} batches)".format(pngs, wall, smi, counts,
                                                                                      n_batches))



def k2_operands(torch, device, gen, int8_mm):
    """K2's probe operands: [(shape name, orientation, (lhs, rhs, scale))]
    for the 8 contractions in both orientations, random int8 and scales
    from `gen`."""
    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=device, dtype=torch.int8)

    k2 = []
    for shape, (cout, cin, p) in int8_mm.PROBE_SHAPES.items():
        w = int8(cout, cin)
        scale = torch.empty(cout, device=device).uniform_(math.log(1e-5), math.log(1e-3), generator=gen).exp_()
        k2.append((shape, "a", (w, int8(cin, p), scale.reshape(cout, 1))))
        k2.append((shape, "b", (int8(p, cin), w.t().contiguous(), scale.reshape(1, cout))))
    return k2


def check_and_time_k2(torch, int8_mm, k2, k2_out, per_kernel, smi):
    """Each K2 output against the plain version (bit-equal) and torch._int_mm's
    int32 against the plain accumulators, then the kernel's events and device
    times (device rate in GB/s against 3.35 TB/s and in TOP/s), the plain
    version's and _int_mm's; adds the sites to per_kernel["K2"]."""
    with torch.no_grad():
        for (shape, orient, args), got in zip(k2, k2_out):
            lhs, rhs, scale = args
            ref = int8_mm.int8_matmul_requant_plain(*args)
            if got.shape != ref.shape or not torch.equal(got, ref):
                raise AssertionError("K2 {} {}: {} of {} outputs differ from the plain version".format(
                    shape, orient, int((got != ref).sum()), ref.numel()))
            if not torch.equal(torch._int_mm(lhs, rhs), int8_mm.int8_matmul_acc_plain(lhs, rhs)):
                raise AssertionError("K2 {} {}: torch._int_mm's int32 differs from the plain accumulators".format(
                    shape, orient))
            del ref
            arg_sets = rotated(torch, args)

            def kernel(a, b, s, o=orient):
                return int8_mm.int8_matmul_requant(a, b, s, o)

            ms = cuda_ms(torch, kernel, arg_sets, 20)
            dev_ms = device_ms(torch, kernel, arg_sets, 20)
            lib_ms = cuda_ms(torch, lambda a, b, s: torch._int_mm(a, b), arg_sets, 20)
            plain_ms = cuda_ms(torch, int8_mm.int8_matmul_requant_plain, arg_sets, 2)
            del arg_sets
            (m, k), n = lhs.shape, rhs.shape[1]
            moved, ops = nbytes(lhs, rhs, scale, got), 2 * m * n * k
            t = dev_ms or ms
            bound_ms, bound_by = bound(moved, ops, "int8")
            record(per_kernel, "K2", "{} {}".format(shape, orient), (m, k, n), 0.0, ms, plain_ms, (moved, ops, "int8"),
                   library_ms=lib_ms, device_ms=dev_ms, gbs=moved / t / 1e6, tops=ops / t / 1e9,
                   share_of_bound=bound_ms / t)
            site = per_kernel["K2"]["sites"][-1]
            log("phase 4: K2 {} {} (M, K, N) = {}: bit-equal, torch._int_mm int32 equal (rhs row-major); kernel "
                "{:.4f} ms (events), {} (device), {:.0f} GB/s ({:.1%} of 3350), {:.1f} TOP/s, {:.1%} of its bound "
                "by {} time; _int_mm {:.4f} ms, plain {:.3f} ms, bound {:.4f} ms ({}); {}".format(
                    shape, orient, (m, k, n), ms, "not measured" if dev_ms is None else "{:.4f} ms".format(dev_ms),
                    site["gbs"], site["gbs"] / 3350, site["tops"], site["share_of_bound"],
                    "events" if dev_ms is None else "device", lib_ms, plain_ms, bound_ms, bound_by, smi))


def run_probes(torch, device, seed, counted, per_kernel, smi):
    """Phase 4: K2 at the 8 contractions in both orientations and K10's 12
    rungs at two sizes, once each with every launch counter at 0 (the
    probes path), then each output against its plain version and the
    timings. Adds K2's and K10's entries to `per_kernel`; returns the
    path's launch counts."""
    from robosat_tpu_torch.ops import head_rungs, int8_mm

    gen = torch.Generator(device=device).manual_seed(seed + 1)
    k2 = k2_operands(torch, device, gen, int8_mm)
    wm = torch.randn((1, 128), generator=gen, device=device) * 0.3
    bm = torch.randn((1, 4), generator=gen, device=device) * 0.5
    side = (TILE + 2 * OVERLAP) // 2  # dec5's grid
    strip = torch.randn((1, 8, side, 128), generator=gen, device=device).to(torch.bfloat16)
    dec5 = (torch.randn((BATCH, side, side, 128), generator=gen, device=device) * 1.5).relu_().to(torch.bfloat16)
    k10 = [(label, rung, (x, wm, bm)) for label, x in (("strip", strip), ("dec5 batch", dec5))
           for rung in head_rungs.RUNGS]

    for fn in counted.values():
        fn.launches = 0
    with torch.no_grad():
        k2_out = [int8_mm.int8_matmul_requant(*args, orient) for _, orient, args in k2]
        k10_out = [head_rungs.head_rung(*args, rung) for _, rung, args in k10]
    torch.cuda.synchronize()
    counts = {name: fn.launches for name, fn in counted.items()}
    expected = {name: {"K2": len(k2), "K10": len(k10)}.get(name, 0) for name in counted}
    if counts != expected:
        raise AssertionError("[probes] launch counts {} != expected {}".format(counts, expected))
    log("phase 4: [probes] launches {}".format({name: c for name, c in counts.items() if c}))

    check_and_time_k2(torch, int8_mm, k2, k2_out, per_kernel, smi)
    del k2, k2_out
    torch.cuda.empty_cache()
    with torch.no_grad():
        for (label, rung, args), got in zip(k10, k10_out):
            ref = head_rungs.head_rung_plain(*args, rung)
            if got.shape != ref.shape or got.dtype != ref.dtype:
                raise AssertionError("K10 {} {}: kernel {} {} vs plain {} {}".format(
                    label, rung, tuple(got.shape), got.dtype, tuple(ref.shape), ref.dtype))
            if got.dtype == torch.uint8:
                flips, err = u8_flips(torch, got, ref)
                if err > 1 or flips > MAX_FLIP_SHARE * got.numel():
                    raise AssertionError("K10 {} {}: {} flipped bins (max distance {})".format(label, rung, flips, err))
                detail = "{} of {} bins flipped by 1".format(flips, got.numel())
            else:
                err = float((got.float() - ref.float()).abs().max())
                if rung.startswith("sigmoid"):
                    ulps = int((got.view(torch.int32).long() - ref.view(torch.int32).long()).abs().max())
                    if ulps > SIGMOID_ULPS:
                        raise AssertionError("K10 {} {}: {} ulps from the plain sigmoid".format(label, rung, ulps))
                    detail = "within {} ulps".format(ulps)
                elif not torch.equal(got, ref):
                    raise AssertionError("K10 {} {}: not bit-equal, max |diff| {}".format(label, rung, err))
                else:
                    detail = "bit-equal"
            arg_sets = rotated(torch, args)
            ms = cuda_ms(torch, lambda x, w, b, r=rung: head_rungs.head_rung(x, w, b, r), arg_sets, 20)
            plain_ms = cuda_ms(torch, lambda x, w, b, r=rung: head_rungs.head_rung_plain(x, w, b, r), arg_sets, 2)
            del arg_sets
            x = args[0]
            ops = {"base": 0, "mul": x.numel()}.get(rung, 2 * x.numel())
            bound_ms, bound_by = record(per_kernel, "K10", "{} {}".format(label, rung), x.shape, float(err), ms,
                                        plain_ms, (nbytes(*args, got), ops, "f32"))
            log("phase 4: K10 {} {} {} -> {}: {}; kernel {:.4f} ms ({:.0f} GB/s), plain {:.3f} ms, bound {:.4f} ms "
                "({})".format(label, rung, tuple(x.shape), tuple(got.shape), detail, ms,
                              nbytes(*args, got) / ms / 1e6, plain_ms, bound_ms, bound_by))
    return {name: c for name, c in counts.items() if c}


def tool_checkpoint_path(work):
    """The U-Net checkpoint phase 6c's second epoch writes under `work`."""
    return os.path.join(work, "train-checkpoints", "checkpoint-00002-of-00002.npz")


def run_phase_process(work, flag, name):
    """The full run's phase 8 (`--fast --fast-from work`, name "fast"), 11
    (`--deeplab --deeplab-from work`, "deeplab"), 12 (`--segformer
    --segformer-from work`, "segformer") or 13 (`--pc --pc-from work`,
    "pc") in a process of its own, its
    output going to this one's: late in one long process
    torch.profiler drops kernel events (device times read "not measured",
    a step profile counts missing launches), and a fresh process profiles
    as `--fast` does. Returns the results it wrote to work/<name>.json
    (per-kernel sites, launches, launches by path); raises if it failed."""
    cmd = [sys.executable, os.path.abspath(__file__), flag, flag + "-from", work]
    proc = subprocess.run(cmd, timeout=900, check=False)
    if proc.returncode != 0:
        raise AssertionError("{} ({}) exited with {}".format(name, " ".join(cmd[1:]), proc.returncode))
    with open(os.path.join(work, name + ".json")) as f:
        return json.load(f)


def run_fast(torch, work, seed, smi, counted, launches, by_path, per_kernel, unet_checkpoint=None, train_root=None):
    """Phase 8: the fast family on config/model-fast.toml as it stands,
    weights from `fastnet.init(seed)`: 8a its kernels against their plain
    versions at full width, 8b the predict paths, 8c the configured train
    steps, 8d the tools. `unet_checkpoint` (phase 6c's) teaches 8d's
    student, and `train_root` (6c's dataset) is its dataset; without them
    (`--fast`) a checkpoint of `unet.init(seed)` and a new dataset stand in.
    Adds the launches of 8b's int8 path and 8d's predict to `launches` and
    `by_path`, and the kernels' sites to `per_kernel`."""
    from robosat_tpu_torch.checkpoint import save_checkpoint, to_jax
    from robosat_tpu_torch.config import load_config
    from robosat_tpu_torch.device import configure_device
    from robosat_tpu_torch.models import fastnet, unet

    configure_device(True)
    tiles_dir = os.path.join(work, "tiles-fast")
    tiles = write_tiles(tiles_dir, seed)  # phase 5's tiles
    params, state = fastnet.init(seed, num_classes=2)
    checkpoint = os.path.join(work, "fast.npz")
    save_checkpoint(checkpoint, {"params": to_jax(params), "state": to_jax(state)}, meta={"epoch": 0})
    fast_kernels(torch, work, tiles_dir, checkpoint, per_kernel, smi)
    torch.cuda.empty_cache()
    model_predict_paths(torch, work, tiles_dir, tiles, checkpoint, fastnet, load_config(FAST_TOML), FAST_PATHS,
                        FAST_INT8_ROUTES, 8, counted, launches, by_path, smi)
    torch.cuda.empty_cache()
    fast_train_steps(torch, seed, smi)
    torch.cuda.empty_cache()
    if train_root is None:
        train_root = os.path.join(work, "slippy")
        write_training_set(train_root, seed)
        u_params, u_state = unet.init(seed)
        unet_checkpoint = os.path.join(work, "unet-teacher.npz")
        save_checkpoint(unet_checkpoint, {"params": to_jax(u_params), "state": to_jax(u_state)}, meta={"epoch": 1})
    fast_tools(torch, work, train_root, unet_checkpoint, counted, launches, by_path, smi)


class SiteInputs:
    """A conv-site cursor of the float calibration walk (int8._Sites) that
    also keeps each site's input, in `dtype` (bf16: as the int8 walk gets it)."""

    def __init__(self, sites, dtype):
        self.sites, self.dtype, self.inputs = sites, dtype, []

    def next_scale(self, x):
        self.inputs.append(x.to(self.dtype))
        return self.sites.next_scale(x)


def fast_kernels(torch, work, tiles_dir, checkpoint, per_kernel, smi):
    """Phase 8a: config/model-fast.toml's first predict batch (8 host-blocked
    576-px tiles) through the float32 calibration walk, which keeps every
    site's input; then rs_int8_conv at the 12 dense sites and K5 at u3, u2
    and u1 on those inputs with the calibrated scales, each against its
    plain version (bf16 bit-equal) and timed as phase 3 times its kernels."""
    from robosat_tpu_torch.checkpoint import load_model_checkpoint
    from robosat_tpu_torch.config import load_config
    from robosat_tpu_torch.data.loader import batches
    from robosat_tpu_torch.models import fastnet, qconv, qdec
    from robosat_tpu_torch.models import int8 as q8
    from robosat_tpu_torch.parallel.steps import _normalize_s2d4
    from robosat_tpu_torch.tools import predict

    common = load_config(FAST_TOML)["common"]
    pargs = predict_args(work, tiles_dir, None, FAST_TOML, checkpoint)
    directory, _ = predict.input_directory(pargs, predict.host_s2d_input(common, pargs))
    raw48 = next(iter(batches(directory, BATCH, workers=2))).arrays[0]
    side = (TILE + 2 * OVERLAP) // 4
    if raw48.shape != (BATCH, side, side, 48):
        raise AssertionError("phase 8: first batch has shape {}".format(raw48.shape))
    params, state, _ = load_model_checkpoint(checkpoint, device=torch.device("cuda"))
    percentile = q8.calibration_spec(common.get("int8_calibration", 99.8))
    with torch.no_grad():
        folded = fastnet.fold(params, state)
        x48 = _normalize_s2d4(torch.as_tensor(raw48).cuda())
        walk = SiteInputs(q8._Sites(scales=None, percentile=percentile), torch.bfloat16)
        fastnet._walk48_sites(folded, x48.float(), walk, float_mode=True)
        amaxes = torch.stack(walk.sites.taps).float().cpu()
        if not torch.equal(amaxes, fastnet.calibration_amaxes_int8(folded, x48, blocked=True, percentile=percentile)):
            raise AssertionError("phase 8: the calibration walk is not reproducible on the card")
        scales = [float(v) for v in q8.scales_from_amaxes(amaxes)]
        qtree = fastnet.quantize_folded_int8(folded)
        fastnet.prepare_int8(qtree, scales)
    del params, state, folded, x48
    log("phase 8: [8a] float32 calibration of {} sites on {} x {} (int8_calibration = {})".format(
        len(scales), BATCH, raw48.shape[1:], common.get("int8_calibration")))
    with torch.no_grad():
        for i, name in enumerate(fastnet._ENC + fastnet._DEC):
            x = walk.inputs[i]
            if name in FAST_DENSE:
                stride, dilation, epilogue = FAST_DENSE[name]
                kname, kernel, plain = "int8_conv", qconv.int8_conv, qconv.int8_conv_plain
                kargs = (x, qtree[name], scales[i], stride, dilation, ((dilation, dilation),) * 2 if dilation > 1
                         else "SAME", epilogue)
            else:
                kname, kernel, plain = "K5", qdec.parity_up_conv, qdec.parity_up_conv_plain
                kargs = (x, qtree[name], scales[i])
            routes = dict(qconv.int8_conv.by_route)
            got, ref = kernel(*kargs), plain(*kargs)
            torch.cuda.synchronize()
            err = float((got.float() - ref.float()).abs().max())
            if got.shape != ref.shape or not torch.equal(got, ref):
                raise AssertionError("phase 8: {} {}: {} vs plain {}, max |diff| {}".format(
                    kname, name, tuple(got.shape), tuple(ref.shape), err))
            route = None
            if kname == "int8_conv":
                route = qconv.route(3, stride, dilation)
                if qconv.int8_conv.by_route != {**routes, route: routes[route] + 1} or route != FAST_ROUTES[name]:
                    raise AssertionError("phase 8: int8_conv {} took {} (by route {} -> {}), expected {}".format(
                        name, route, routes, qconv.int8_conv.by_route, FAST_ROUTES[name]))
                if route == "halo":
                    plan = qconv.halo_plan(x.shape, got.shape[-1], dilation, got.shape[1:3])
                    route_note = "halo_conv_kernel (halo side {}, {} tiles of 8 x 8, {} items, BN {})".format(
                        plan.side, plan.n_tiles, plan.items, plan.bn)
                else:
                    route_note = "conv_kernel"
            arg_sets = rotated(torch, kargs)
            ms = cuda_ms(torch, kernel, arg_sets, 20)
            dev_ms = device_ms(torch, kernel, arg_sets, 20)
            plain_ms = cuda_ms(torch, plain, arg_sets, 2)
            del arg_sets
            cost = site_work(kname, kargs, got)
            tops = cost[1] / (dev_ms or ms) / 1e9
            extra = {"kernel": route} if route else {}
            bound_ms, bound_by = record(per_kernel, kname, name + " (fast)", x.shape, err, ms, plain_ms, cost,
                                        device_ms=dev_ms, tops=tops, **extra)
            log("phase 8: [8a] {} {} {} -> {}{}: bit-equal; kernel {:.4f} ms (events), {} (device), {:.1f} TOP/s "
                "({:.1%} of 1979), plain {:.3f} ms, bound {:.4f} ms ({}); {}".format(
                    kname, name, tuple(x.shape), tuple(got.shape), " on " + route_note if route else "", ms,
                    "not measured" if dev_ms is None else "{:.4f} ms".format(dev_ms), tops, tops / 1979, plain_ms,
                    bound_ms, bound_by, smi))
    del walk, qtree, got, ref


def model_predict_paths(torch, work, tiles_dir, tiles, checkpoint, model, base, paths, int8_routes, phase, counted,
                        launches, by_path, smi, exact=False):
    """Phase 8b, 11b or 12b (`phase`): `predict.main` with the family's model
    TOML `base` along `paths` (label, keys over `base`, launches per batch
    of each kernel: the int8 path as configured, then `int8 = false`),
    each through a TOML copy in the work directory, every launch count set
    to 0 just before and read just after: 64 palette PNGs, the path's
    launches and, on the int8 path, rs_int8_conv's by route
    (`int8_routes` a batch), steady tiles/s; then the first batch through
    the kernels against the plain step (+-1 bin on <= 0.1% of pixels; with
    `exact`, bit-equal) and equal to the PNGs written, the step by CUDA
    events, and a profile of the step."""
    from PIL import Image

    from robosat_tpu_torch.checkpoint import load_model_checkpoint
    from robosat_tpu_torch.config import save_config
    from robosat_tpu_torch.data.loader import batches
    from robosat_tpu_torch.models import int8 as q8
    from robosat_tpu_torch.models import qconv
    from robosat_tpu_torch.parallel.steps import make_int8_predict_step, make_predict_step
    from robosat_tpu_torch.tools import predict

    prefix = "phase {}: [{}b".format(phase, phase)
    params, state, _ = load_model_checkpoint(checkpoint, device=torch.device("cuda"))
    pngs_by_path = {}
    for label, keys, per_batch in paths:
        config = {**base, "common": {**base["common"], **keys}}
        model_toml = os.path.join(work, "model-{}.toml".format(label))
        save_config(config, model_toml)
        probs = os.path.join(work, "probs-{}".format(label))
        pargs = predict_args(work, tiles_dir, probs, model_toml, checkpoint)
        host_s2d = predict.host_s2d_input(config["common"], pargs)
        directory, _ = predict.input_directory(pargs, host_s2d)
        first = next(iter(batches(directory, BATCH, workers=2)))
        n_batches = -(-len(directory) // BATCH)
        for fn in counted.values():
            fn.launches = 0
        qconv.int8_conv.by_route = dict.fromkeys(qconv.int8_conv.by_route, 0)
        start = time.perf_counter()
        out = predict.main(pargs)
        wall = time.perf_counter() - start
        counts = {name: fn.launches for name, fn in counted.items()}
        expected = {name: per_batch.get(name, 0) * n_batches for name in counted}
        if counts != expected or out["tiles"] != len(tiles):
            raise AssertionError("[{}] {} tiles, launch counts {} != expected {}".format(label, out["tiles"], counts,
                                                                                       expected))
        routes = {r: c * n_batches if per_batch.get("int8_conv") else 0 for r, c in int8_routes.items()}
        if qconv.int8_conv.by_route != routes:
            raise AssertionError("[{}] rs_int8_conv launches by route {} != expected {}".format(
                label, qconv.int8_conv.by_route, routes))
        by_path[label] = {name: c for name, c in counts.items() if c}
        for name, c in by_path[label].items():
            launches[name] += c
        steady = len(tiles) - len(first.meta)
        log("{} {}] predict wrote {} tiles in {:.2f} s; steady {:.2f} tiles/s over {} tiles ({:.3f} s) on "
            "{}; {} batches of {} x {}; host-blocked input {}; launches {}, rs_int8_conv's by route {}".format(
                prefix, label, out["tiles"], wall, steady / out["steady_s"], steady, out["steady_s"], smi, n_batches,
                BATCH, first.arrays[0].shape[1:], host_s2d, by_path[label], qconv.int8_conv.by_route))
        for x, y, z in tiles:
            img = Image.open(os.path.join(probs, str(z), str(x), "{}.png".format(y)))
            img.load()
            if img.mode != "P" or img.size != (TILE, TILE):
                raise AssertionError("[{}] tile {}: {} {}".format(label, (x, y, z), img.mode, img.size))
        pngs_by_path[label] = read_pngs(probs, tiles)

        raw = first.arrays[0]
        if config["common"].get("int8", False):
            step, qt = make_int8_predict_step(model, params, state, raw, overlap=OVERLAP, host_s2d=host_s2d,
                                              calib_percentile=q8.calibration_spec(
                                                  config["common"].get("int8_calibration", 99.8)))

            def run_step(plain=False, step=step, qt=qt, raw=raw):
                return step(qt, raw, plain=plain)
        else:
            float_step = make_predict_step(model, overlap=OVERLAP, compute_dtype=torch.bfloat16, fused_head=True,
                                           host_s2d=host_s2d)

            def run_step(plain=False, float_step=float_step, raw=raw):
                return float_step(params, state, raw, plain=plain)
        got = run_step()
        start_ev, end_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start_ev.record()
        ref = run_step(plain=True)
        end_ev.record()
        torch.cuda.synchronize()
        step_ms = cuda_ms(torch, run_step, [()], 5)
        flips, err = u8_flips(torch, got, ref)
        fine = fine_u8(got)
        if fine.shape != (BATCH, TILE, TILE) or err > 1 or flips > (0 if exact else MAX_FLIP_SHARE * got.numel()):
            raise AssertionError("[{}] step {}: {} flipped bins vs the plain path (max distance {})".format(
                label, tuple(got.shape), flips, err))
        written = read_pngs(probs, [tuple(t) for t in first.meta])
        if not np.array_equal(written, fine):
            raise AssertionError("[{}] predict's PNGs differ from the step's output on {} pixels".format(
                label, int((written != fine).sum())))
        log("{} {}] batch {} -> {} through the kernels vs the plain path: {} of {} bins flipped by 1; "
            "step {:.2f} ms with kernels (CUDA events), {:.2f} ms plain; PNGs match the kernel step".format(
                prefix, label, raw.shape, tuple(got.shape), flips, got.numel(), step_ms, start_ev.elapsed_time(end_ev)))
        log_step_profile(torch, run_step, label, per_batch, phase="phase {}".format(phase))
        del run_step, got, ref
        torch.cuda.empty_cache()
    if len(paths) != 2:
        return
    (int8_label, _, _), (float_label, _, _) = paths
    flips, err = u8_flips(torch, torch.from_numpy(pngs_by_path[int8_label]), torch.from_numpy(pngs_by_path[float_label]))
    log("{}] int8 PNGs vs the bf16 run's (counted only: random weights, another datapath): {} of {} pixels "
        "differ, max distance {}".format(prefix, flips, pngs_by_path[int8_label].size, err))


def time_train_steps(torch, prefix, step, params, state, extra, images, masks, seed, loss_name, dtype, groups, smi):
    """TRAIN_STEPS steps of `step` on one batch (losses finite, the last
    below the first), each timed by CUDA events, then a profile of
    PROFILE_STEPS more (kernels by `groups`); logs after `prefix` and
    returns (numbers, the final state)."""
    batch, size = images.shape[0], images.shape[1]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    torch.cuda.synchronize()
    losses, events = [], []
    for _ in range(TRAIN_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, loss, _ = step(params, state, *extra, images, masks, gen)
        end.record()
        losses.append(loss)
        events.append((start, end))
    torch.cuda.synchronize()
    losses = [float(v) for v in losses]
    step_ms = [a.elapsed_time(b) for a, b in events]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError("{}: {} losses {}".format(prefix, loss_name, losses))
    median_ms = float(np.median(step_ms[2:]))
    log("{} {} {} batch {} at {} px, augmentation on: {} losses {}".format(
        prefix, smi, str(dtype)[6:], batch, size, loss_name, ["{:.5f}".format(v) for v in losses]))
    log("{} step ms by CUDA events {}; median over steps 3-{} {:.2f} ms = {:.1f} images/s; "
        "max_memory_allocated {:.2f} GB".format(prefix, ["{:.2f}".format(v) for v in step_ms], TRAIN_STEPS, median_ms,
                                                batch / median_ms * 1e3, peak_gb))
    holder = {"state": state}

    def one_step():
        holder["state"], _, _ = step(params, holder["state"], *extra, images, masks, gen)

    idle = log_train_profile(torch, prefix, one_step, groups)
    return {"median_ms": median_ms, "images_per_s": batch / median_ms * 1e3, "peak_gb": peak_gb, "idle": idle,
            "first_loss": losses[0], "last_loss": losses[-1]}, holder["state"]


def fast_train_steps(torch, seed, smi):
    """Phase 8c: config/model-fast.toml's train steps as it stands (bf16,
    its loss, batch 64 at 512 px, augmentation on) on one learnable batch:
    the plain step from `fastnet.init`, distillation of `fastnet.init` by a
    folded `unet.init` teacher (alpha 0.9, T 2), and QAT from the plain
    step's weights with the config's calibration on that batch (the state
    returned unchanged). Returns the numbers."""
    from robosat_tpu_torch import optim
    from robosat_tpu_torch.checkpoint import from_jax, to_jax
    from robosat_tpu_torch.config import load_config
    from robosat_tpu_torch.models import fastnet, unet
    from robosat_tpu_torch.models import int8 as q8
    from robosat_tpu_torch.ops.augment import normalize
    from robosat_tpu_torch.ops.losses import get_loss
    from robosat_tpu_torch.parallel.steps import make_distill_train_step, make_qat_train_step, make_train_step

    config = load_config(FAST_TOML)
    common, opt = config["common"], config["opt"]
    batch, size = common["batch_size"], common["image_size"]
    dtype = torch.bfloat16 if common.get("bf16", False) else torch.float32
    weight = PARKING_WEIGHTS if opt["loss"] != "Lovasz" else None
    loss_fn = get_loss(opt["loss"])
    images, masks = learnable_batches(np.random.default_rng(seed + 8), 1, batch, size)[0]
    images, masks = torch.from_numpy(images).pin_memory(), torch.from_numpy(masks).pin_memory()
    params0, state0 = fastnet.init(seed)
    results = {}

    def fresh():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        return from_jax(to_jax(params0), to_jax(state0), "cuda")

    params, state = fresh()
    step = make_train_step(fastnet, loss_fn, optim.adam(params, opt["lr"]), weight=weight, compute_dtype=dtype)
    results["plain"], state = time_train_steps(torch, "phase 8: [8c plain]", step, params, state, (), images, masks,
                                               seed, opt["loss"], dtype, TRAIN_KERNEL_GROUPS, smi)
    trained = {"params": params, "state": state}
    del step

    t_params, t_state = unet.init(seed)
    with torch.no_grad():
        teacher = unet.fold(*from_jax(to_jax(t_params), to_jax(t_state), "cuda"))
    params, state = fresh()
    step = make_distill_train_step(fastnet, unet, loss_fn, optim.adam(params, opt["lr"]), weight=weight,
                                   compute_dtype=dtype)
    results["distillation"], _ = time_train_steps(torch, "phase 8: [8c distillation]", step, params, state,
                                                  (teacher,), images, masks, seed, opt["loss"], dtype,
                                                  TRAIN_KERNEL_GROUPS, smi)
    del step, teacher, params, state

    with torch.no_grad():
        amaxes = fastnet.calibration_amaxes_int8(fastnet.fold(trained["params"], trained["state"]),
                                                 normalize(images.cuda()),
                                                 percentile=q8.calibration_spec(common.get("int8_calibration", 99.8)))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, state = trained["params"], trained["state"]
    step = make_qat_train_step(fastnet, loss_fn, optim.adam(params, opt["lr"]), list(q8.scales_from_amaxes(amaxes)),
                               weight=weight, compute_dtype=dtype)
    results["QAT"], returned = time_train_steps(torch, "phase 8: [8c QAT]", step, params, state, (), images, masks,
                                                seed, opt["loss"], dtype, QAT_KERNEL_GROUPS, smi)
    if returned is not state:
        raise AssertionError("8c QAT: the step did not return the state it was given")
    log("phase 8: [8c] {}".format(json.dumps(results)))
    return results


def fast_tools(torch, work, root, unet_checkpoint, counted, launches, by_path, smi):
    """Phase 8d, on the dataset at `root` (TOML copies with batch
    TOOL_BATCH): `train --model config/model-fast.toml --teacher
    <unet_checkpoint> --teacher_model config/model-unet.toml` for one epoch,
    `--resume` to epoch 2, `train --qat` for one epoch from that checkpoint,
    then int8 `predict` from the QAT checkpoint over the training tiles,
    which must quantize with its 15 qat_amaxes and calibrate nothing (12
    rs_int8_conv and 3 K5 launches a batch)."""
    from robosat_tpu_torch.checkpoint import load_checkpoint
    from robosat_tpu_torch.config import load_config, save_config
    from robosat_tpu_torch.models import fastnet
    from robosat_tpu_torch.tools import predict, train

    base = load_config(FAST_TOML)
    dataset = load_config(os.path.join(ROOT, "config", "dataset-parking.toml"))
    dataset["common"]["dataset"] = root
    dataset_toml = os.path.join(work, "dataset-fast.toml")
    save_config(dataset, dataset_toml)
    steps = TRAIN_TILES_SIDE ** 2 // TOOL_BATCH
    distill_dir, qat_dir = os.path.join(work, "train-fast"), os.path.join(work, "train-fast-qat")
    teacher = {"teacher": unet_checkpoint, "teacher_model": os.path.join(ROOT, "config", "model-unet.toml")}
    runs = (("--teacher", distill_dir, 1, dict(teacher)),
            ("--teacher --resume", distill_dir, 2,
             dict(teacher, checkpoint=os.path.join(distill_dir, "checkpoint-00001-of-00001.npz"), resume=True)),
            ("--qat", qat_dir, 1, {"qat": True, "checkpoint": os.path.join(distill_dir, "checkpoint-00002-of-00002.npz")}))
    params_keys = set(fastnet._ENC + fastnet._DEC + ("final",)) | {name + "_bn" for name in fastnet._ENC}
    for i, (label, ckpt_dir, epochs, flags) in enumerate(runs):
        config = {**base, "common": {**base["common"], "batch_size": TOOL_BATCH, "checkpoint": ckpt_dir},
                  "opt": {**base["opt"], "epochs": epochs}}
        model_toml = os.path.join(work, "model-fast-train-{}.toml".format(i))
        save_config(config, model_toml)
        args = argparse.Namespace(model=model_toml, dataset=dataset_toml, checkpoint=None, resume=False, workers=4,
                                  profile=None, teacher=None, teacher_model=None, distill_alpha=0.9, distill_temp=2.0,
                                  qat=False)
        for key, value in flags.items():
            setattr(args, key, value)
        start = time.perf_counter()
        out = train.main(args)
        wall = time.perf_counter() - start
        name = "checkpoint-{:05d}-of-{:05d}.npz".format(epochs, epochs)
        trees, meta = load_checkpoint(os.path.join(ckpt_dir, name))
        lines = open(os.path.join(ckpt_dir, "log")).read().splitlines()
        want_line = ("QAT finetune: 15 int8 sites, int8_calibration = {} (frozen)".format(
            base["common"].get("int8_calibration")) if label == "--qat"
            else "Distilling from: {} (alpha 0.9, T 2.0)".format(unet_checkpoint))
        count = int(trees["opt_state"][0])
        want_count = 2 * steps if label == "--teacher --resume" else steps
        if out["steps"] != steps or count != want_count or want_line not in lines \
                or ("qat_amaxes" in meta) != (label == "--qat") or set(trees["params"]) != params_keys:
            raise AssertionError("8d {}: steps {}, count {}, meta {}, log {}".format(label, out["steps"], count,
                                                                                   sorted(meta), lines))
        log("phase 8: [8d] train {}: {} steps in {:.2f} s on {}; {} (opt_state count {}); {}".format(
            label, out["steps"], wall, smi, name, count, want_line))
    qat_checkpoint = os.path.join(qat_dir, "checkpoint-00001-of-00001.npz")
    qat_amaxes = load_checkpoint(qat_checkpoint)[1]["qat_amaxes"]
    if len(qat_amaxes) != 15 or not all(a > 0 and math.isfinite(a) for a in qat_amaxes):
        raise AssertionError("8d: qat_amaxes {}".format(qat_amaxes))

    seen = {"calibrations": 0, "calib_amaxes": None}
    real_calibration, real_step = fastnet.calibration_amaxes_int8, predict.make_int8_predict_step

    def calibration(*args, **kwargs):
        seen["calibrations"] += 1
        return real_calibration(*args, **kwargs)

    def int8_step(*args, **kwargs):
        seen["calib_amaxes"] = kwargs.get("calib_amaxes")
        return real_step(*args, **kwargs)

    fastnet.calibration_amaxes_int8, predict.make_int8_predict_step = calibration, int8_step
    try:
        counts, pngs, wall, n_batches = predict_split_tiles(root, os.path.join(work, "probs-fast-qat"),
                                                            qat_checkpoint, counted, "8d predict",
                                                            model_toml=FAST_TOML, per_batch=FAST_INT8)
    finally:
        fastnet.calibration_amaxes_int8, predict.make_int8_predict_step = real_calibration, real_step
    if seen["calibrations"] or seen["calib_amaxes"] is None or \
            not np.array_equal(np.asarray(seen["calib_amaxes"], np.float64), np.asarray(qat_amaxes, np.float64)):
        raise AssertionError("8d predict: {} calibrations, scales from {}".format(
            seen["calibrations"], "a calibration" if seen["calib_amaxes"] is None else "other amaxes"))
    by_path["fast-qat-predict"] = counts
    for name, c in counts.items():
        launches[name] += c
    log("phase 8: [8d] predict (config/model-fast.toml) from the QAT checkpoint: quantized with its 15 qat_amaxes, "
        "no calibration; {} PNGs in {:.2f} s on {}; launches {} ({} batches)".format(pngs, wall, smi, counts,
                                                                                      n_batches))


def family_toml(work, model):
    """A TOML copy of config/model-unet.toml with `model` set (as
    tests/test_deeplab.py and tests/test_segformer.py configure their
    families) in `work`, as model-<model>.toml; returns (path, config)."""
    from robosat_tpu_torch.config import load_config, save_config

    base = load_config(os.path.join(ROOT, "config", "model-unet.toml"))
    config = {**base, "common": {**base["common"], "model": model}}
    path = os.path.join(work, "model-{}.toml".format(model))
    save_config(config, path)
    return path, config


def run_deeplab(torch, work, seed, smi, counted, launches, by_path, per_kernel, train_root=None):
    """Phase 11: DeepLabv3+ on a copy of config/model-unet.toml with model
    = "deeplabv3plus", weights from `deeplab.init(seed)`: 11a its kernels
    against their plain versions at full width, 11b the predict paths, 11c
    the configured train step and the tools. `train_root` (6c's dataset)
    is 11c's dataset; without it (`--deeplab`) a new one stands in. Adds
    the launches of 11b's int8 path and 11c's predict to `launches` and
    `by_path`, and the kernels' sites to `per_kernel`."""
    from robosat_tpu_torch.checkpoint import save_checkpoint, to_jax
    from robosat_tpu_torch.device import configure_device
    from robosat_tpu_torch.models import deeplab

    configure_device(True)
    model_toml, config = family_toml(work, "deeplabv3plus")
    tiles_dir = os.path.join(work, "tiles-deeplab")
    tiles = write_tiles(tiles_dir, seed)  # phase 5's tiles
    params, state = deeplab.init(seed, num_classes=2)
    checkpoint = os.path.join(work, "deeplab.npz")
    save_checkpoint(checkpoint, {"params": to_jax(params), "state": to_jax(state)}, meta={"epoch": 0})
    del params, state
    deeplab_kernels(torch, work, tiles_dir, checkpoint, model_toml, config, per_kernel, smi)
    torch.cuda.empty_cache()
    model_predict_paths(torch, work, tiles_dir, tiles, checkpoint, deeplab, config, DEEPLAB_PATHS, DEEPLAB_INT8_ROUTES,
                        11, counted, launches, by_path, smi)
    torch.cuda.empty_cache()
    family_train_step(torch, seed, config, smi, deeplab, "phase 11: [11c step]")
    torch.cuda.empty_cache()
    if train_root is None:
        train_root = os.path.join(work, "slippy")
        write_training_set(train_root, seed)
    family_tools(torch, work, train_root, config, counted, launches, by_path, smi, deeplab, 11, DEEPLAB_INT8)


def taps_inside(h, w, k, dilation, pads, out_hw):
    """(output pixel, tap) pairs of a stride-1 k x k conv of `dilation` over
    an h x w grid, `pads` (top, left) zero rows and columns before it, whose
    input pixel lies inside the grid (the taps in the padding read zeros)."""

    def axis(size, pad, out):
        return sum(1 for t in range(k) for o in range(out) if 0 <= o + t * dilation - pad < size)

    return axis(h, pads[0], out_hw[0]) * axis(w, pads[1], out_hw[1])


def deeplab_site_work(name, kargs, out):
    """(bytes, operations, operation type, share of the taps inside the
    grid) of a phase-11 kernel call: as `site_work`, but a 3x3 conv counts
    only the taps that land inside the grid (K3's conv2 at dilation 2, the
    ASPP convs at 6/12/18, the decoder's)."""
    x = kargs[0]
    n, h, w, cin = x.shape
    io = nbytes(x, out)
    if name == "K3":
        qb, d = kargs[1], kargs[6]
        cmid, cout = qb["conv1"]["wq"].shape[-1], qb["conv3"]["wq"].shape[-1]
        pairs = taps_inside(h, w, 3, d, (d, d), (h, w))
        macs = n * (h * w * (cin * cmid + cmid * cout + (cin * cout if "down_conv" in qb else 0)) + pairs * cmid * cmid)
        return io + nbytes(*(node["wq"] for node in qb.values())), 2 * macs, "int8", pairs / (9 * h * w)
    node, dilation = kargs[1], kargs[4]
    k, cout = node["wq"].shape[0], node["wq"].shape[-1]
    if k == 1:
        return io + nbytes(node["wq"]), 2 * n * h * w * cin * cout, "int8", 1.0
    pairs = taps_inside(h, w, k, dilation, (dilation, dilation), (h, w))
    return io + nbytes(node["wq"]), 2 * n * pairs * cin * cout, "int8", pairs / (k * k * h * w)


def deeplab_kernels(torch, work, tiles_dir, checkpoint, model_toml, config, per_kernel, smi):
    """Phase 11a: the first predict batch (8 host-blocked 576-px tiles)
    through DeepLab's float32 calibration walk, which keeps every site's
    input; then K3 at layer4.0 (dilation 2, projection) and layer4.1
    (dilation 2), and rs_int8_conv at its seven sites, each on the route
    qconv.route names, on those inputs with the calibrated scales: each
    against its plain version (bf16 bit-equal), timed as phase 3 times its
    kernels, with a bound that counts only the taps inside the grid."""
    from robosat_tpu_torch.checkpoint import load_model_checkpoint
    from robosat_tpu_torch.data.loader import batches
    from robosat_tpu_torch.models import deeplab, qconv, qenc
    from robosat_tpu_torch.models import int8 as q8
    from robosat_tpu_torch.models.resnet import RESNET50_STAGES
    from robosat_tpu_torch.parallel.steps import _normalize_s2d4
    from robosat_tpu_torch.tools import predict

    common = config["common"]
    pargs = predict_args(work, tiles_dir, None, model_toml, checkpoint)
    directory, _ = predict.input_directory(pargs, predict.host_s2d_input(common, pargs))
    raw48 = next(iter(batches(directory, BATCH, workers=2))).arrays[0]
    side = (TILE + 2 * OVERLAP) // 4
    if raw48.shape != (BATCH, side, side, 48):
        raise AssertionError("phase 11: first batch has shape {}".format(raw48.shape))
    params, state, _ = load_model_checkpoint(checkpoint, device=torch.device("cuda"))
    percentile = q8.calibration_spec(common.get("int8_calibration", 99.8))
    with torch.no_grad():
        folded = deeplab.fold(params, state)
        x48 = _normalize_s2d4(torch.as_tensor(raw48).cuda())
        walk = SiteInputs(q8._Sites(scales=None, percentile=percentile), torch.bfloat16)
        deeplab._walk_int8(folded, x48.float(), walk, float_mode=True, blocked=True)
        amaxes = torch.stack(walk.sites.taps).float().cpu()
        if not torch.equal(amaxes, deeplab.calibration_amaxes_int8(folded, x48, blocked=True, percentile=percentile)):
            raise AssertionError("phase 11: the calibration walk is not reproducible on the card")
        scales = [float(v) for v in q8.scales_from_amaxes(amaxes)]
        qtree = deeplab.quantize_folded_int8(folded)
        deeplab.prepare_int8(qtree, scales)
    del params, state, folded, x48
    log("phase 11: [11a] float32 calibration of {} sites on {} x {} (int8_calibration = {})".format(
        len(scales), BATCH, raw48.shape[1:], common.get("int8_calibration", 99.8)))
    # Site index of each block's conv1 in walk order (conv1, conv2, conv3, down_conv).
    first_site, i = {}, 0
    for si, (blocks, _) in enumerate(RESNET50_STAGES):
        for bi, qb in enumerate(qtree["encoder"]["layer{}".format(si + 1)]):
            first_site[(si + 1, bi)] = i
            i += 3 + ("down_conv" in qb)
    cases = []
    for bi in (0, 1):
        j, qb = first_site[(4, bi)], qtree["encoder"]["layer4"][bi]
        sd = scales[j + 3] if "down_conv" in qb else None
        cases.append(("K3", "layer4.{} ({}, dilation 2)".format(bi, "projection" if sd else "identity"),
                      qenc.bottleneck_block, lambda *a: qenc.bottleneck_block_plain(*a[:6], dilation=a[6]),
                      (walk.inputs[j], qb, scales[j], scales[j + 1], scales[j + 2], sd, 2)))
    for j, (name, dilation) in enumerate(deeplab.DENSE_SITES, start=i):
        cases.append(("int8_conv", name, qconv.int8_conv, qconv.int8_conv_plain,
                      (walk.inputs[j], qtree[name], scales[j], 1, dilation, "SAME", "relu")))
    if i + len(deeplab.DENSE_SITES) != len(scales):
        raise AssertionError("phase 11: {} sites walked, {} scales".format(i + len(deeplab.DENSE_SITES), len(scales)))
    with torch.no_grad():
        for kname, site, kernel, plain, kargs in cases:
            x = kargs[0]
            routes = dict(qconv.int8_conv.by_route)
            got, ref = kernel(*kargs), plain(*kargs)
            torch.cuda.synchronize()
            err = float((got.float() - ref.float()).abs().max())
            if got.shape != ref.shape or not torch.equal(got, ref):
                raise AssertionError("phase 11: {} {}: {} vs plain {}, max |diff| {}".format(
                    kname, site, tuple(got.shape), tuple(ref.shape), err))
            route, note = None, ""
            if kname == "int8_conv":
                k, dilation = kargs[1]["wq"].shape[0], kargs[4]
                route = qconv.route(k, 1, dilation)
                want = "halo" if site.startswith("dec") else "conv_kernel"
                if qconv.int8_conv.by_route != {**routes, route: routes[route] + 1} or route != want:
                    raise AssertionError("phase 11: int8_conv {} took {} (by route {} -> {}), expected {}".format(
                        site, route, routes, qconv.int8_conv.by_route, want))
                note = " {}x{} dilation {} on {}".format(k, k, dilation, route)
                if route == "halo":
                    plan = qconv.halo_plan(x.shape, got.shape[-1], dilation, got.shape[1:3])
                    note += " (halo side {}, {} tiles of 8 x 8, {} items, BN {})".format(
                        plan.side, plan.n_tiles, plan.items, plan.bn)
            arg_sets = rotated(torch, kargs)
            ms = cuda_ms(torch, kernel, arg_sets, 20)
            dev_ms = device_ms(torch, kernel, arg_sets, 20)
            plain_ms = cuda_ms(torch, plain, arg_sets, 2)
            del arg_sets
            nbytes_, ops, op_type, inside = deeplab_site_work(kname, kargs, got)
            tops = ops / (dev_ms or ms) / 1e9
            extra = {"kernel": route} if route else {}
            bound_ms, bound_by = record(per_kernel, kname, site + " (deeplab)", x.shape, err, ms, plain_ms,
                                        (nbytes_, ops, op_type), device_ms=dev_ms, tops=tops, taps_inside=inside,
                                        **extra)
            log("phase 11: [11a] {} {}{} {} -> {}: bit-equal; kernel {:.4f} ms (events), {} (device), {:.1f} TOP/s "
                "({:.1%} of 1979) of the work inside the grid, plain {:.3f} ms, bound {:.4f} ms ({}; the taps inside "
                "the grid: {:.1%} of the 3x3 taps); {}".format(
                    kname, site, note, tuple(x.shape), tuple(got.shape), ms,
                    "not measured" if dev_ms is None else "{:.4f} ms".format(dev_ms), tops, tops / 1979, plain_ms,
                    bound_ms, bound_by, inside, smi))
    del walk, qtree, got, ref


def run_segformer(torch, work, seed, smi, counted, launches, by_path, per_kernel, train_root=None):
    """Phase 12: SegFormer (MiT-B0) on a copy of config/model-unet.toml
    with model = "segformer", weights from `segformer.init(seed)`: 12a its
    kernels against their plain versions at every int8 site, 12b the
    predict paths (the int8 PNGs bit-equal to the plain path's), 12c the
    configured train step and the tools. `train_root` (6c's dataset) is
    12c's dataset; without it (`--segformer`) a new one stands in. Adds the
    launches of 12b's int8 path and 12c's predict to `launches` and
    `by_path`, and the kernels' sites to `per_kernel`."""
    from robosat_tpu_torch.checkpoint import save_checkpoint, to_jax
    from robosat_tpu_torch.device import configure_device
    from robosat_tpu_torch.models import segformer

    configure_device(True)
    model_toml, config = family_toml(work, "segformer")
    tiles_dir = os.path.join(work, "tiles-segformer")
    tiles = write_tiles(tiles_dir, seed)  # phase 5's tiles
    params, state = segformer.init(seed, num_classes=2)
    checkpoint = os.path.join(work, "segformer.npz")
    save_checkpoint(checkpoint, {"params": to_jax(params), "state": to_jax(state)}, meta={"epoch": 0})
    del params, state
    segformer_kernels(torch, work, tiles_dir, checkpoint, model_toml, config, per_kernel, smi)
    torch.cuda.empty_cache()
    model_predict_paths(torch, work, tiles_dir, tiles, checkpoint, segformer, config, SEGFORMER_PATHS,
                        SEGFORMER_INT8_ROUTES, 12, counted, launches, by_path, smi, exact=True)
    torch.cuda.empty_cache()
    family_train_step(torch, seed, config, smi, segformer, "phase 12: [12c step]")
    torch.cuda.empty_cache()
    if train_root is None:
        train_root = os.path.join(work, "slippy")
        write_training_set(train_root, seed)
    family_tools(torch, work, train_root, config, counted, launches, by_path, smi, segformer, 12, SEGFORMER_INT8)


def pc_site(torch, per_kernel, smi, kname, site, kernel, plain, kargs, bit_equal=True, work_fn=None):
    """Phase 13a: one per-channel site through its kernel and its plain
    version (bit-equal, or for K6's head +-1 bin on <= 0.1%), timed as
    phase 3 times its kernels (events, device time, plain), its bound from
    `work_fn` (default `site_work`); recorded under `kname` as "<site> (pc)"."""
    got, ref = kernel(*kargs), plain(*kargs)
    torch.cuda.synchronize()
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError("phase 13: {} {}: kernel {} vs plain {}".format(kname, site, tuple(got.shape),
                                                                          tuple(ref.shape)))
    if bit_equal:
        err = float((got.float() - ref.float()).abs().max())
        if not torch.equal(got, ref):
            raise AssertionError("phase 13: {} {}: not bit-equal, max |diff| {}".format(kname, site, err))
        detail = "bit-equal"
    else:
        flips, err = u8_flips(torch, got, ref)
        if err > 1 or flips > MAX_FLIP_SHARE * got.numel():
            raise AssertionError("phase 13: {} {}: {} flipped bins (max distance {})".format(kname, site, flips, err))
        detail = "{} of {} bins flipped by 1".format(flips, got.numel())
    arg_sets = rotated(torch, kargs)
    ms = cuda_ms(torch, kernel, arg_sets, 20)
    dev_ms = device_ms(torch, kernel, arg_sets, 20)
    plain_ms = cuda_ms(torch, plain, arg_sets, 2)
    del arg_sets
    cost = (work_fn or site_work)(kname, kargs, got)[:3]
    tops = cost[1] / (dev_ms or ms) / 1e9
    bound_ms, bound_by = record(per_kernel, kname, site + " (pc)", kargs[0].shape, err, ms, plain_ms, cost,
                                device_ms=dev_ms, tops=tops)
    log("phase 13: [13a] {} {} (per-channel) {} -> {}: {}; kernel {:.4f} ms (events), {} (device), {:.1f} TOP/s "
        "({:.1%} of 1979), plain {:.3f} ms, bound {:.4f} ms ({}); {}".format(
            kname, site, tuple(kargs[0].shape), tuple(got.shape), detail, ms,
            "not measured" if dev_ms is None else "{:.4f} ms".format(dev_ms), tops, tops / 1979, plain_ms, bound_ms,
            bound_by, smi))


def pc_calibrate(torch, walk_fn, quantize, folded, x48, label):
    """A family's per-channel (PC_SPEC) calibration on the card: the float32
    walk through `walk_fn(folded, x, sites)` keeping each site's bf16 input,
    then `quantize(folded, act_amaxes=taps)`. Returns (qtree, host scale
    vectors, site inputs)."""
    from robosat_tpu_torch.models import int8 as q8

    torch.cuda.synchronize()
    start = time.perf_counter()
    walk = SiteInputs(q8._Sites(scales=None, percentile=PC_SPEC), torch.bfloat16)
    walk_fn(folded, x48.float(), walk)
    taps = q8.site_taps(walk.sites, PC_SPEC)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - start
    start = time.perf_counter()
    qtree, scale_list = quantize(folded, act_amaxes=taps)
    scales = q8.host_scales(scale_list)
    torch.cuda.synchronize()
    log("phase 13: [13a] {}: float32 calibration ({}) of {} sites on {} x {} in {:.2f} s (host clock, "
        "synchronized; the walk keeps each site's input), the balanced fold and quantize in {:.2f} s".format(
            label, PC_SPEC, len(scales), x48.shape[0], tuple(x48.shape[1:]), calib_s, time.perf_counter() - start))
    return qtree, scales, walk.inputs


def run_pc(torch, work, seed, smi, counted, launches, by_path, per_kernel, train_root=None):
    """Phase 13: the per-channel calibration (int8_calibration = PC_SPEC)
    of the U-Net, the fast family and DeepLab, weights from each family's
    `init(seed)`, on phase 5's tiles. 13a: each family's float32
    calibration walk on the first predict batch (8 host-blocked 576-px
    tiles) keeping every site's input, the balanced fold, then the kernels'
    per-channel instantiations at main-path sites on those inputs against
    their plain versions, timed as phase 3: K3 at layer1.0 and layer3.1, K4
    at layer2.0, K5 at center, dec1 and dec3, K6 dec3 -> head (the U-Net);
    rs_int8_conv at b1, down2 and d1 (the fast family); K3 at layer4.0
    (dilation 2) and rs_int8_conv at aspp_d2 (DeepLab). 13b: `predict.main`
    for the U-Net through a TOML copy of config/model-unet.toml with
    int8_calibration = PC_SPEC, as model_predict_paths runs a path. 13c:
    one batch of each family's per-channel int8 step against its plain
    step (the fast family's and DeepLab's launches counted), timed in turns
    with the per-tensor step. `train_root` is unused (the signature of the
    other family phases)."""
    from robosat_tpu_torch.checkpoint import load_model_checkpoint, save_checkpoint, to_jax
    from robosat_tpu_torch.config import load_config
    from robosat_tpu_torch.data.loader import batches
    from robosat_tpu_torch.device import configure_device
    from robosat_tpu_torch.models import deeplab, fastnet, qconv, qdec, qenc, qtail, unet
    from robosat_tpu_torch.models import int8 as q8
    from robosat_tpu_torch.models.resnet import RESNET50_STAGES
    from robosat_tpu_torch.parallel.steps import _normalize_s2d4, make_int8_predict_step
    from robosat_tpu_torch.tools import predict

    device = configure_device(True)
    tiles_dir = os.path.join(work, "tiles-pc")
    tiles = write_tiles(tiles_dir, seed)  # phase 5's tiles
    base = load_config(os.path.join(ROOT, "config", "model-unet.toml"))
    checkpoints = {}
    for name, model in (("unet", unet), ("fast", fastnet), ("deeplab", deeplab)):
        params, state = model.init(seed, num_classes=2)
        checkpoints[name] = os.path.join(work, "pc-{}.npz".format(name))
        save_checkpoint(checkpoints[name], {"params": to_jax(params), "state": to_jax(state)}, meta={"epoch": 0})
    del params, state
    pargs = predict_args(work, tiles_dir, None, None, checkpoints["unet"])
    directory, _ = predict.input_directory(pargs, True)
    raw48 = next(iter(batches(directory, BATCH, workers=2))).arrays[0]
    side = (TILE + 2 * OVERLAP) // 4
    if raw48.shape != (BATCH, side, side, 48):
        raise AssertionError("phase 13: first batch has shape {}".format(raw48.shape))
    x48 = _normalize_s2d4(torch.as_tensor(raw48).to(device))

    # ---- 13a: the kernels' per-channel instantiations at main-path sites ----
    with torch.no_grad():
        params, state, _ = load_model_checkpoint(checkpoints["unet"], device=device)
        folded = unet.fold(params, state)
        qtree, scales, inputs = pc_calibrate(
            torch, lambda f, x, s: q8._walk(f, x, s, float_mode=True, blocked=True), q8.quantize_unet_folded, folded,
            x48, "U-Net")
        del params, state, folded
        enc = qtree["encoder"]

        def block(site, down):
            return [scales[site + i] for i in range(4 if down else 3)]

        cases = [
            ("K3", "layer1.0 (projection)", qenc.bottleneck_block, qenc.bottleneck_block_plain,
             (inputs[0], enc["layer1"][0], *block(0, True)), True),
            ("K3", "layer3.1 (identity)", qenc.bottleneck_block, qenc.bottleneck_block_plain,
             (inputs[27], enc["layer3"][1], *block(27, False)), True),
            ("K4", "layer2.0", qenc.bottleneck_block_s2, qenc.bottleneck_block_s2_plain,
             (inputs[10], enc["layer2"][0], *block(10, True)), True),
        ] + [
            ("K5", name, qdec.parity_up_conv, qdec.parity_up_conv_plain, (inputs[site], qtree[name], scales[site]), True)
            for name, site in (("center", 52), ("dec1", 54), ("dec3", 56))
        ] + [
            ("K6", "dec3 -> head", qtail.fused_tail, qtail.fused_tail_plain,
             (inputs[57], qtree["dec4"], scales[57], qtree["dec5"], scales[58], qtree["final"]["w"],
              qtree["final"]["b"], OVERLAP), False),
        ]
        for kname, site, kernel, plain, kargs, bit_equal in cases:
            pc_site(torch, per_kernel, smi, kname, site + " (unet)", kernel, plain, kargs, bit_equal)
        del cases, inputs, qtree, enc
        torch.cuda.empty_cache()

        params, state, _ = load_model_checkpoint(checkpoints["fast"], device=device)
        folded = fastnet.fold(params, state)
        qtree, scales, inputs = pc_calibrate(
            torch, lambda f, x, s: fastnet._walk48_sites(f, x, s, float_mode=True), fastnet.quantize_folded_int8,
            folded, x48, "fast family")
        fastnet.prepare_int8(qtree, scales)
        del params, state, folded
        order = fastnet._ENC + fastnet._DEC
        for name in ("b1", "down2", "d1"):
            i = order.index(name)
            stride, dilation, epilogue = FAST_DENSE[name]
            pc_site(torch, per_kernel, smi, "int8_conv", name + " (fast)", qconv.int8_conv, qconv.int8_conv_plain,
                    (inputs[i], qtree[name], scales[i], stride, dilation, "SAME", epilogue))
        del inputs, qtree
        torch.cuda.empty_cache()

        params, state, _ = load_model_checkpoint(checkpoints["deeplab"], device=device)
        folded = deeplab.fold(params, state)
        qtree, scales, inputs = pc_calibrate(
            torch, lambda f, x, s: deeplab._walk_int8(f, x, s, float_mode=True, blocked=True),
            deeplab.quantize_folded_int8, folded, x48, "DeepLab")
        deeplab.prepare_int8(qtree, scales)
        del params, state, folded
        j = sum(3 + ("down_conv" in qb) for si in range(len(RESNET50_STAGES) - 1)
                for qb in qtree["encoder"]["layer{}".format(si + 1)])  # layer4.0's conv1
        pc_site(torch, per_kernel, smi, "K3", "layer4.0 (projection, dilation 2) (deeplab)", qenc.bottleneck_block,
                lambda *a: qenc.bottleneck_block_plain(*a[:6], dilation=a[6]),
                (inputs[j], qtree["encoder"]["layer4"][0], *scales[j:j + 4], 2), work_fn=deeplab_site_work)
        i = len(scales) - len(deeplab.DENSE_SITES) + 3  # aspp_d2, dilation 18
        pc_site(torch, per_kernel, smi, "int8_conv", "aspp_d2 (dilation 18) (deeplab)", qconv.int8_conv,
                qconv.int8_conv_plain, (inputs[i], qtree["aspp_d2"], scales[i], 1, 18, "SAME", "relu"),
                work_fn=deeplab_site_work)
        del inputs, qtree, x48
        torch.cuda.empty_cache()

    # ---- 13b: rs predict for the U-Net with the per-channel calibration ----
    model_predict_paths(torch, work, tiles_dir, tiles, checkpoints["unet"], unet, base, PC_PATHS,
                        {"halo": 0, "conv_kernel": 0}, 13, counted, launches, by_path, smi)
    torch.cuda.empty_cache()

    # ---- 13c: one batch of each family's per-channel step, and beside it the per-tensor one ----
    # (amax: a per-tensor percentile takes ~10 s of kthvalue over whole
    # tensors on the card, and the step's time does not depend on the spec)
    for label, model, per_batch in (("unet-" + PC_SPEC, unet, None), ("fast-" + PC_SPEC, fastnet, FAST_INT8),
                                    ("deeplab-" + PC_SPEC, deeplab, DEEPLAB_INT8)):
        params, state, _ = load_model_checkpoint(checkpoints[label.split("-")[0]], device=device)
        steps, build_s = {}, {}
        for spec in (None, PC_SPEC):
            torch.cuda.synchronize()
            start = time.perf_counter()
            steps[spec] = make_int8_predict_step(model, params, state, raw48, overlap=OVERLAP, host_s2d=True,
                                                 calib_percentile=spec)
            torch.cuda.synchronize()
            build_s[spec] = time.perf_counter() - start
        step, qt = steps[PC_SPEC]
        for fn in counted.values():
            fn.launches = 0
        got = step(qt, raw48)
        torch.cuda.synchronize()
        counts = {name: fn.launches for name, fn in counted.items()}
        if per_batch is not None:  # the U-Net's launches are 13b's
            if counts != {name: per_batch.get(name, 0) for name in counted}:
                raise AssertionError("phase 13: [{}] launch counts {} != expected {}".format(label, counts,
                                                                                          per_batch))
            by_path[label] = {name: c for name, c in counts.items() if c}
            for name, c in by_path[label].items():
                launches[name] += c
        ref = step(qt, raw48, plain=True)
        torch.cuda.synchronize()
        flips, err = u8_flips(torch, got, ref)
        if err > 1 or flips > MAX_FLIP_SHARE * got.numel():
            raise AssertionError("phase 13: [{}] {} flipped bins vs the plain step (max distance {})".format(
                label, flips, err))
        # The per-tensor and the per-channel step in turns: per-tensor, pc, pc, per-tensor.
        timed = {None: [], PC_SPEC: []}
        for spec in (None, PC_SPEC, PC_SPEC, None):
            run_step, run_qt = steps[spec]
            timed[spec].append(cuda_ms(torch, lambda: run_step(run_qt, raw48), [()], 5))
        log("phase 13: [13c {}] steps built (fold, calibration, quantize, packing) in {:.2f} s (amax) / {:.2f} s "
            "({}); batch {} -> {} through the kernels (launches {}) vs the plain step: {} of {} bins flipped by 1; "
            "step by CUDA events, per-tensor / per-channel / per-channel / per-tensor: {:.2f} / {:.2f} / {:.2f} / "
            "{:.2f} ms; {}".format(label, build_s[None], build_s[PC_SPEC], PC_SPEC, raw48.shape, tuple(got.shape),
                                   {n: c for n, c in counts.items() if c}, flips, got.numel(), timed[None][0],
                                   timed[PC_SPEC][0], timed[PC_SPEC][1], timed[None][1], smi))
        del steps, step, qt, params, state, got, ref
        torch.cuda.empty_cache()

def mesh_env(port, size, rank):
    """The RS_* environment of rank `rank` of `size` processes (parallel/mesh.py)."""
    return {"RS_COORDINATOR": "127.0.0.1:{}".format(port), "RS_NUM_PROCESSES": str(size), "RS_PROCESS_ID": str(rank)}


def start_ranks(work, task, size):
    """`size` processes of `chip_smoke.py --mesh-rank task --mesh-from work`,
    RS_* set for each (a fresh port), their output to work/mesh/<task><r>.log."""
    from robosat_tpu_torch.parallel.mesh import free_port

    port = free_port()
    procs = []
    for rank in range(size):
        out = open(os.path.join(work, "mesh", "{}{}.log".format(task, rank)), "w")
        cmd = [sys.executable, os.path.abspath(__file__), "--mesh-rank", task, "--mesh-from", work]
        procs.append((subprocess.Popen(cmd, env=dict(os.environ, **mesh_env(port, size, rank)), stdout=out,
                                       stderr=subprocess.STDOUT), out))
    return procs


def wait_ranks(procs, timeout):
    """The ranks' exit codes and outputs; a rank past `timeout` is killed."""
    codes, logs = [], []
    deadline = time.perf_counter() + timeout
    for proc, out in procs:
        try:
            codes.append(proc.wait(timeout=max(deadline - time.perf_counter(), 1)))
        except subprocess.TimeoutExpired:
            proc.kill()
            codes.append(proc.wait())
        out.close()
        with open(out.name) as f:
            logs.append(f.read())
    return codes, logs


def mesh_raster(seed):
    """14b's raster: MESH_RASTER^2 px of the phase-5 imagery's kind, one image."""
    rng = np.random.default_rng(seed + 14)
    yy, xx = np.mgrid[0:MESH_RASTER, 0:MESH_RASTER].astype(np.float32)
    base = 0.5 + 0.35 * np.stack([np.sin(xx / (23 + 7 * c) + yy / (31 + 5 * c)) for c in range(3)], -1)
    return np.clip(base * 255 + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8)[None]


def mesh_train_steps(torch, seed, images, masks, mesh=None, sync_bn=True, dtype=None, steps=MESH_TRAIN_STEPS):
    """`steps` of config/model-unet.toml's train step (its dtype,
    bf16, unless `dtype` says otherwise; its loss; augmentation off) from
    `mesh_train_weights(seed)` on (images, masks), which are this rank's
    rows with a `mesh`: (losses, bn1's running mean and variance, the
    weights as one float32 vector), all on the host."""
    from robosat_tpu_torch import optim
    from robosat_tpu_torch.checkpoint import from_jax, to_jax, tree_leaves
    from robosat_tpu_torch.config import load_config
    from robosat_tpu_torch.models import unet
    from robosat_tpu_torch.ops.losses import get_loss
    from robosat_tpu_torch.parallel.steps import make_train_step

    config = load_config(os.path.join(ROOT, "config", "model-unet.toml"))
    opt = config["opt"]
    params, state = from_jax(*(to_jax(t) for t in mesh_train_weights(torch, seed)), "cuda")
    step = make_train_step(unet, get_loss(opt["loss"]), optim.adam(params, opt["lr"]),
                           weight=PARKING_WEIGHTS if opt["loss"] != "Lovasz" else None,
                           compute_dtype=dtype or (torch.bfloat16 if config["common"].get("bf16") else torch.float32),
                           augment=False, mesh=mesh, sync_bn=sync_bn)
    images, masks = torch.from_numpy(images).pin_memory(), torch.from_numpy(masks).pin_memory()
    losses = []
    for _ in range(steps):
        state, loss, _ = step(params, state, images, masks)
        losses.append(loss)
    torch.cuda.synchronize()
    flat = torch.cat([p.detach().float().reshape(-1) for p in tree_leaves(params)]).cpu().numpy()
    bn = torch.cat([state["encoder"]["bn1"][k].float() for k in ("mean", "var")]).cpu().numpy()
    del params, state, step
    torch.cuda.empty_cache()
    return [float(v) for v in losses], bn, flat


def mesh_train_weights(torch, seed):
    """`unet.init(seed)` with phase 6a's reference-style kernels
    (N(0, 0.05^2)), whose losses stay where two faithful trajectories can be
    held to 5%: (params, state) on the host."""
    from robosat_tpu_torch.models import unet

    params, state = unet.init(seed)
    return reference_style(torch, params, seed), state


def check_train_agreement(label, got, want, start, step0=1e-4):
    """PERF.md section 2's training agreement between two runs of
    `mesh_train_steps`: step 0's loss within `step0` relative (1e-4; in
    bf16 MESH_BF16_STEP0), steps 1-2 within 5%, bn1's running statistics
    within 5e-3; the update's cosine after the last step is printed
    (Adam's first updates are ~lr * sign(grad), so near-zero gradients'
    signs follow the summation order)."""
    (g_losses, g_bn, g_flat), (w_losses, w_bn, w_flat) = got, want
    rel = [abs(a - b) / abs(b) for a, b in zip(g_losses, w_losses)]
    bn_err = float(np.abs(g_bn - w_bn).max())
    cos = float(np.dot(g_flat - start, w_flat - start) /
                (np.linalg.norm(g_flat - start) * np.linalg.norm(w_flat - start) + 1e-30))
    log("phase 14: {}: losses {} vs {} (relative {}), bn1's statistics max |diff| {:.3g}, update cosine {:.5f}".format(
        label, ["{:.5f}".format(v) for v in g_losses], ["{:.5f}".format(v) for v in w_losses],
        ["{:.2e}".format(v) for v in rel], bn_err, cos))
    if rel[0] > step0 or max(rel[1:]) > 0.05 or bn_err > 5e-3:
        raise AssertionError("{}: outside the training agreement".format(label))


def mesh_first_batch(torch, work):
    """Phase 5's first int8 batch (8 host-blocked 576-px tiles), as predict loads it."""
    from robosat_tpu_torch.data.loader import batches
    from robosat_tpu_torch.tools import predict

    directory, _ = predict.input_directory(predict_args(work, os.path.join(work, "tiles"), None, None, None), True)
    return next(iter(batches(directory, BATCH, workers=2))).arrays[0]


def mesh_predict_toml(work):
    """config/model-unet.toml with int8_calibration = MESH_CALIBRATION."""
    from robosat_tpu_torch.config import load_config, save_config

    config = load_config(os.path.join(ROOT, "config", "model-unet.toml"))
    config["common"]["int8_calibration"] = MESH_CALIBRATION
    path = os.path.join(work, "mesh", "model-unet-mesh.toml")
    save_config(config, path)
    return path


def mesh_train_args(work, root, name):
    """`train` one epoch on 6c's dataset at TOOL_BATCH, checkpoints in work/mesh/name."""
    from robosat_tpu_torch.config import load_config, save_config

    base = load_config(os.path.join(ROOT, "config", "model-unet.toml"))
    config = {**base, "common": {**base["common"], "batch_size": TOOL_BATCH,
                                 "checkpoint": os.path.join(work, "mesh", name)}, "opt": {**base["opt"], "epochs": 1}}
    dataset = load_config(os.path.join(ROOT, "config", "dataset-parking.toml"))
    dataset["common"]["dataset"] = root
    model_toml, dataset_toml = (os.path.join(work, "mesh", name + suffix) for suffix in ("-model.toml", "-data.toml"))
    save_config(config, model_toml)
    save_config(dataset, dataset_toml)
    return argparse.Namespace(model=model_toml, dataset=dataset_toml, checkpoint=None, resume=False, workers=4,
                              profile=None)


def run_mesh(torch, work, seed, smi, counted, launches, by_path, per_kernel, train_root=None):
    """Phase 14: the multi-device layer (parallel/mesh.py) on the one card.

    14a, a real NCCL group of one rank through `maybe_init_distributed`
    with RS_* set to localhost: the configured train step (bf16, its loss,
    batch 64 at 512 px, augmentation off, sync_bn) for MESH_TRAIN_STEPS
    against the step without a mesh, within PERF.md section 2's training
    agreement (step 0 within MESH_BF16_STEP0 in bf16; in float32, on the
    batch's first MESH_F32_ROWS rows, within 1e-4); the int8 predict step
    (MESH_CALIBRATION) on phase 5's first batch, bit-equal to the step
    without a mesh. Then two NCCL ranks on the
    one card, which NCCL refuses ("Duplicate GPU detected"; the error is
    printed). 14b, two ranks on the card over gloo (NCCL needs a card
    each; gloo stages CUDA tensors through the host, so its times are of
    correctness, not of NCCL's links): `make_spatial_predict_step` on one
    MESH_RASTER^2 raster, overlap 32, float32, against the one-process
    `make_predict_step` (within one bin on at most 0.1% of the pixels, the
    flips counted; K1 launches counted on each rank as `spatial`; both
    steps timed by CUDA events), and K1 on each rank's own features against
    its plain version under the same rule; the configured train step,
    batch 64 split 32/32, against the one-process step, sync_bn true (the
    batch's 64 rows) and false (each rank the same 32 rows, against one
    process on them); in float32 on MESH_F32_ROWS split over the ranks,
    sync_bn true within 1e-4 of 14a's one process on them, and each rank's
    own statistics (the control) outside that bound; `train.main` one epoch
    on 6c's dataset and int8 `predict.main` on phase 5's tiles
    (MESH_CALIBRATION), each as 2 processes under RS_*: rank 0 alone
    writes the checkpoint, the PNGs equal the one-process run's within one
    bin on at most 0.1%, and each rank's int8 step on its rows of the first
    batch against the plain step under the same rule."""
    import torch.distributed as dist

    from robosat_tpu_torch.checkpoint import load_model_checkpoint, save_checkpoint, to_jax, tree_leaves
    from robosat_tpu_torch.config import load_config
    from robosat_tpu_torch.device import configure_device
    from robosat_tpu_torch.models import unet
    from robosat_tpu_torch.parallel.mesh import create_mesh, free_port
    from robosat_tpu_torch.parallel.steps import make_int8_predict_step, make_predict_step
    from robosat_tpu_torch.tools import predict, train

    marks = [time.perf_counter()]
    device = configure_device(True)
    os.makedirs(os.path.join(work, "mesh"), exist_ok=True)
    if not os.path.isdir(os.path.join(work, "tiles")):
        write_tiles(os.path.join(work, "tiles"), seed)
    if train_root is None:
        train_root = os.path.join(work, "slippy")
        write_training_set(train_root, seed)
    checkpoint = os.path.join(work, "mesh", "unet.npz")
    save_checkpoint(checkpoint, {"params": to_jax(unet.init(seed)[0]), "state": to_jax(unet.init(seed)[1])},
                    meta={"epoch": 0})
    # The NCCL probe (14a's last part) runs beside this process's work, and
    # 14b's ranks start now and wait, their CUDA set up, for work/mesh/go.
    nccl = start_ranks(work, "nccl", MESH_RANKS)
    ranks = start_ranks(work, "gloo", MESH_RANKS)
    try:

        # ---- 14a: a one-rank NCCL group --------------------------------------
        os.environ.update(mesh_env(free_port(), 1, 0))
        start = time.perf_counter()
        mesh = create_mesh(device)
        log("phase 14: [14a] {} group of {} rank(s) through RS_* in {:.2f} s, device {}".format(
            dist.get_backend(), mesh.size, time.perf_counter() - start, mesh.device))
        config = load_config(os.path.join(ROOT, "config", "model-unet.toml"))["common"]
        images, masks = learnable_batches(np.random.default_rng(seed + 7), 1, config["batch_size"],
                                          config["image_size"])[0]
        start_w = np.concatenate([t.float().reshape(-1).numpy()
                                  for t in tree_leaves(mesh_train_weights(torch, seed)[0])])
        t0 = time.perf_counter()
        runs = {}
        for dtype, rows in ((torch.float32, MESH_F32_ROWS), (None, len(images))):
            runs[dtype] = [mesh_train_steps(torch, seed, images[:rows], masks[:rows], use_mesh, dtype=dtype)
                           for use_mesh in (mesh, None)]
        check_train_agreement("[14a] train float32 ({} rows), NCCL one rank vs no mesh".format(MESH_F32_ROWS),
                              *runs[torch.float32], start_w)
        check_train_agreement("[14a] train as configured (bf16), NCCL one rank vs no mesh", *runs[None], start_w,
                              step0=MESH_BF16_STEP0)
        log("phase 14: [14a] {} train steps each of the four ways in {:.2f} s".format(MESH_TRAIN_STEPS,
                                                                                     time.perf_counter() - t0))
        # 14a's steps without a mesh are 14b's references too: float32 on
        # MESH_F32_ROWS rows, and the configured step on the batch's 64.
        f32_ref, train_sync = runs[torch.float32][1], runs[None][1]
        del runs
        raw48 = mesh_first_batch(torch, work)
        params, state, _ = load_model_checkpoint(checkpoint, device=device)
        outs = []
        for use_mesh in (mesh, None):
            step, qtree = make_int8_predict_step(unet, params, state, raw48, overlap=OVERLAP, host_s2d=True,
                                                 calib_percentile=None, mesh=use_mesh)
            for fn in counted.values():
                fn.launches = 0
            outs.append(step(qtree, raw48))
            torch.cuda.synchronize()
            if use_mesh is not None:
                by_path["mesh-nccl-predict"] = {name: fn.launches for name, fn in counted.items() if fn.launches}
        if not torch.equal(outs[0], outs[1]) or by_path["mesh-nccl-predict"] != PATHS[0][3]:
            raise AssertionError("14a: the int8 step on the NCCL mesh differs from the step without one, or launched "
                                 "{}".format(by_path["mesh-nccl-predict"]))
        log("phase 14: [14a] int8 predict ({} calibration) on the one-rank NCCL mesh: bit-equal to the step without a "
            "mesh, {}; launches {}".format(MESH_CALIBRATION, tuple(outs[0].shape), by_path["mesh-nccl-predict"]))
        del params, state, step, qtree, outs
        dist.destroy_process_group()
        for key in ("RS_COORDINATOR", "RS_NUM_PROCESSES", "RS_PROCESS_ID"):
            os.environ.pop(key)
        torch.cuda.empty_cache()

        # ---- 14b references, in this process ---------------------------------
        raster = mesh_raster(seed)
        params, state, _ = load_model_checkpoint(checkpoint, device=device)
        single = make_predict_step(unet, overlap=OVERLAP, fused_head=True, fold_bn=True, s2d=True)
        spatial_ref = single(params, state, raster)
        ms = cuda_ms(torch, lambda r: single(params, state, r), [(raster,)], 3)
        spatial_ref = spatial_ref.cpu().numpy()
        log("phase 14: [14b] one-process make_predict_step on the {0}x{0} raster, float32: {1:.3f} ms by CUDA events "
            "on {2}".format(MESH_RASTER, ms, smi))
        del params, state
        np.save(os.path.join(work, "mesh", "images.npy"), images)
        np.save(os.path.join(work, "mesh", "masks.npy"), masks)
        with open(os.path.join(work, "mesh", "setup.json"), "w") as f:
            json.dump({"train_root": train_root}, f)
        half = len(images) // MESH_RANKS
        train_local = mesh_train_steps(torch, seed, images[:half], masks[:half])
        single_train = train.main(mesh_train_args(work, train_root, "train-single"))
        predict.main(predict_args(work, os.path.join(work, "tiles"), os.path.join(work, "mesh", "probs-single"),
                                  mesh_predict_toml(work), checkpoint))
        lap(marks, "phase 14 (14a and 14b's one-process references)")

        codes, logs = wait_ranks(nccl, 120)
        refused = [line for text in logs for line in text.splitlines() if "Duplicate GPU" in line]
        log("phase 14: [14a] two NCCL ranks on the one card: exit codes {}; {}".format(
            codes, refused[0].strip()[:300] if refused else "no 'Duplicate GPU' error"))
        if all(c == 0 for c in codes) or not refused:
            raise AssertionError("14a: NCCL did not refuse two ranks on one card:\n" +
                                 "\n".join(t[-2000:] for t in logs))

        # ---- 14b: two ranks over gloo ----------------------------------------
        log("phase 14: [14b] {} ranks on {} over gloo (passed to maybe_init_distributed; NCCL refuses two ranks on "
            "one card)".format(MESH_RANKS, smi))
        open(os.path.join(work, "mesh", "go"), "w").close()
        codes, logs = wait_ranks(ranks, 600)
        for rank, text in enumerate(logs):
            for line in text.splitlines():
                if line.startswith("phase 14"):
                    log("  rank {} | {}".format(rank, line))
        if any(codes):
            raise AssertionError("14b: rank exit codes {}:\n{}".format(codes, "\n".join(t[-3000:] for t in logs)))
        results = []
        for rank in range(MESH_RANKS):
            with open(os.path.join(work, "mesh", "gloo{}.json".format(rank))) as f:
                results.append(json.load(f))
        spatial = np.load(os.path.join(work, "mesh", "spatial0.npy"))
        flips, err = u8_flips(torch, torch.from_numpy(spatial), torch.from_numpy(spatial_ref))
        if spatial.shape != spatial_ref.shape or err > 1 or flips > MAX_FLIP_SHARE * spatial.size:
            raise AssertionError("14b spatial: {} vs {}, {} flips (max {})".format(spatial.shape, spatial_ref.shape,
                                                                                flips, err))
        if [r["spatial_launches"] for r in results] != [1] * MESH_RANKS:
            raise AssertionError("14b spatial: K1 launches by rank {}".format([r["spatial_launches"] for r in results]))
        by_path["spatial"] = {"K1": sum(r["spatial_launches"] for r in results)}
        log("phase 14: [14b] spatial step, 2 ranks over gloo: {} uint8 against one process: {} of {} bins flipped "
            "by 1; {:.3f} ms (rank 0) / {:.3f} ms (rank 1) by CUDA events against {:.3f} (one process, no "
            "exchange), K1 launches {} by rank".format(spatial.shape, flips, spatial.size, results[0]["spatial_ms"],
                                                       results[1]["spatial_ms"], ms,
                                                       [r["spatial_launches"] for r in results]))
        rank_train = [np.load(os.path.join(work, "mesh", "train-{}.npz".format(kind))) for kind in ("sync", "local")]
        # sync_bn's global statistics run the JAX package's float32 formula where
        # the step without a mesh runs cuDNN's batch norm: in bf16 the two round
        # apart; the local step runs cuDNN's on both sides.
        for kind, ref, got, step0 in (
                ("sync_bn = true, 64 rows split 32/32", train_sync, rank_train[0], MESH_BF16_STEP0),
                ("sync_bn = false, each rank the same 32 rows", train_local, rank_train[1], 1e-4)):
            check_train_agreement("[14b] train (bf16), 2 ranks, " + kind,
                                  (list(got["losses"]), got["bn"], got["flat"]), ref, start_w, step0=step0)
        # float32, 8 rows split 4/4, against 14a's one process on them: the
        # synchronized statistics within section 2's 1e-4, and the same
        # step on each rank's own statistics (the fault a missing
        # all-reduce would make) outside it.
        sync32, local32 = (np.load(os.path.join(work, "mesh", "train-{}.npz".format(k)))
                           for k in ("sync-f32", "local-f32"))
        check_train_agreement("[14b] train float32, 2 ranks, sync_bn = true, {} rows split {}/{}".format(
            MESH_F32_ROWS, MESH_F32_ROWS // MESH_RANKS, MESH_F32_ROWS // MESH_RANKS),
            (list(sync32["losses"]), sync32["bn"], sync32["flat"]), f32_ref, start_w)
        per_rank = abs(float(local32["losses"][0]) - f32_ref[0][0]) / abs(f32_ref[0][0])
        log("phase 14: [14b] train float32, 2 ranks, each rank's own statistics on the same rows (the control): step "
            "0's loss {:.5f} vs {:.5f}, relative {:.2e}; bn1's statistics max |diff| {:.3g}".format(
                float(local32["losses"][0]), f32_ref[0][0], per_rank, float(np.abs(local32["bn"] - f32_ref[1]).max())))
        if per_rank <= 1e-4:
            raise AssertionError("14b: step 0's 1e-4 bound does not tell per-rank batch statistics from global ones")
        for rank, r in enumerate(results):
            for key, what in (("k1", "K1 (G = 4) on the rank's spatial features"),
                              ("int8_rows", "the int8 step (K3-K6) on the rank's rows of predict's first batch")):
                c = r[key]
                log("phase 14: [14b] rank {} {} {} vs its plain version: {} of {} bins flipped (max distance {}); "
                    "{:.3f} ms with kernels, {:.3f} ms plain, by CUDA events on {}".format(
                        rank, what, tuple(c["shape"]), c["flips"], c["bins"], c["max_err"], c["ms"], c["plain_ms"],
                        smi))
        hist, want = results[0]["train_history"], single_train["history"]
        rel = max(abs(hist[k][0] - want[k][0]) / abs(want[k][0]) for k in want if "loss" in k)
        files = sorted(os.listdir(os.path.join(work, "mesh", "train-mesh")))
        if results[1]["train_history"] != hist or rel > 0.05 or files != sorted(
                os.listdir(os.path.join(work, "mesh", "train-single"))):
            raise AssertionError("14b train.main: history {} vs {}, files {}".format(hist, want, files))
        log("phase 14: [14b] train.main one epoch, 2 ranks: {} steps each, losses within {:.2%} of one process's, "
            "rank 0's files {}".format([r["train_steps"] for r in results], rel, files))
        single_pngs, mesh_pngs = (png_dict(os.path.join(work, "mesh", d)) for d in ("probs-single", "probs-mesh"))
        if sorted(single_pngs) != sorted(mesh_pngs) or len(mesh_pngs) != TILES_SIDE ** 2:
            raise AssertionError("14b predict.main: {} PNGs vs {}".format(len(mesh_pngs), len(single_pngs)))
        flips = 0
        for key, ref in single_pngs.items():
            f, e = u8_flips(torch, torch.from_numpy(mesh_pngs[key]), torch.from_numpy(ref))
            if e > 1 or f > MAX_FLIP_SHARE * ref.size:
                raise AssertionError("14b predict.main: {}: {} flips (max {})".format(key, f, e))
            flips += f
        n_batches = TILES_SIDE ** 2 // BATCH
        by_path["mesh-predict"] = {}
        for r in results:
            if r["predict_launches"] != {name: c * n_batches for name, c in PATHS[0][3].items()}:
                raise AssertionError("14b predict.main: a rank launched {}".format(r["predict_launches"]))
            for name, c in r["predict_launches"].items():
                by_path["mesh-predict"][name] = by_path["mesh-predict"].get(name, 0) + c
        log("phase 14: [14b] predict.main int8 ({}), 2 ranks: {} PNGs, {} bins flipped by 1 against one process; "
            "launches {} by rank, {} in all".format(MESH_CALIBRATION, len(mesh_pngs), flips,
                                                     [r["predict_launches"] for r in results], by_path["mesh-predict"]))
        for path in ("mesh-nccl-predict", "spatial", "mesh-predict"):
            for name, c in by_path[path].items():
                launches[name] = launches.get(name, 0) + c
        lap(marks, "phase 14 (14b)")
    finally:
        for proc, out in nccl + ranks:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()


def png_dict(probs):
    """{relative path: palette indices} of every PNG under `probs`."""
    from PIL import Image

    out = {}
    for dirpath, _, names in os.walk(probs):
        for name in names:
            path = os.path.join(dirpath, name)
            out[os.path.relpath(path, probs)] = np.asarray(Image.open(path))
    return out


def run_mesh_rank(torch, task, work):
    """One rank of phase 14 (`--mesh-rank TASK --mesh-from WORK`, RS_* set
    by run_mesh). TASK "nccl": an all-reduce over NCCL, which two ranks on
    one card must not pass. TASK "gloo": 14b's rank: sets up CUDA, waits for
    run_mesh's work/mesh/go (its references done), joins the gloo group,
    then the spatial step (its K1 launches counted, its call timed by CUDA
    events) and K1 on its features against the plain version, the train
    steps sync_bn true (its rows of the batch) and false (the batch's
    first 32 rows), the float32 steps on its rows of MESH_F32_ROWS
    (sync_bn true and false), `train.main` and `predict.main` (launches
    counted), and the int8 step on its rows of predict's first batch
    against the plain step; rank 0 saves the arrays, each rank its numbers
    in work/mesh/gloo<rank>.json."""
    import torch.distributed as dist

    from robosat_tpu_torch.checkpoint import load_model_checkpoint
    from robosat_tpu_torch.device import configure_device
    from robosat_tpu_torch.models import unet
    from robosat_tpu_torch.ops import head
    from robosat_tpu_torch.parallel.mesh import create_mesh, maybe_init_distributed, shard_batch
    from robosat_tpu_torch.parallel.steps import make_int8_predict_step, make_spatial_predict_step
    from robosat_tpu_torch.tools import predict, train

    device = configure_device(True)
    if task == "nccl":
        maybe_init_distributed(use_cuda=True)
        torch.cuda.set_device(0)
        dist.all_reduce(torch.ones(1, device="cuda"))
        torch.cuda.synchronize()
        log("phase 14: [14a] an NCCL all-reduce over two ranks of one card returned")
        return
    torch.zeros(1, device="cuda")  # the CUDA context, set up while run_mesh works
    go = os.path.join(work, "mesh", "go")
    deadline = time.perf_counter() + 600
    while not os.path.exists(go):
        if time.perf_counter() > deadline:
            raise AssertionError("phase 14: no go from run_mesh in 600 s")
        time.sleep(0.05)
    mesh = create_mesh(device, backend="gloo")
    marks = [time.perf_counter()]
    mdir = os.path.join(work, "mesh")
    with open(os.path.join(mdir, "setup.json")) as f:
        train_root = json.load(f)["train_root"]
    checkpoint = os.path.join(mdir, "unet.npz")
    out = {"rank": mesh.rank, "backend": dist.get_backend()}

    params, state, _ = load_model_checkpoint(checkpoint, device=mesh.device)
    raster = mesh_raster(SEED)
    step = make_spatial_predict_step(unet, mesh, overlap=OVERLAP)
    # K1 at this path's shape: the kernel and its plain version on the
    # rank's own features (whose forward warms the step up).
    inputs = step.head_inputs(params, state, raster)
    got, ref = head.margin_head(*inputs, 0, 4), head.margin_head_plain(*inputs, 0, 4)
    flips, err = u8_flips(torch, got, ref)
    out["k1"] = {"shape": list(inputs[0].shape), "dtype": str(inputs[0].dtype), "flips": flips, "bins": got.numel(),
                 "max_err": err, "ms": cuda_ms(torch, head.margin_head, [inputs + (0, 4)], 5),
                 "plain_ms": cuda_ms(torch, head.margin_head_plain, [inputs + (0, 4)], 5)}
    if err > 1 or flips > MAX_FLIP_SHARE * got.numel():
        raise AssertionError("phase 14: [14b] rank {} K1 vs its plain version: {}".format(mesh.rank, out["k1"]))
    del inputs, got, ref
    torch.cuda.synchronize()
    head.margin_head.launches = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    spatial = step(params, state, raster)
    end.record()
    torch.cuda.synchronize()
    out["spatial_launches"], out["spatial_ms"] = head.margin_head.launches, start.elapsed_time(end)
    if mesh.rank == 0:
        np.save(os.path.join(mdir, "spatial0.npy"), spatial.cpu().numpy())
    del params, state, spatial
    lap(marks, "phase 14: [14b] rank {} spatial step".format(mesh.rank))

    images, masks = np.load(os.path.join(mdir, "images.npy")), np.load(os.path.join(mdir, "masks.npy"))
    half = len(images) // mesh.size
    f32_images, f32_masks = images[:MESH_F32_ROWS], masks[:MESH_F32_ROWS]
    runs = {"sync": mesh_train_steps(torch, SEED, shard_batch(mesh, images), shard_batch(mesh, masks), mesh, True),
            "local": mesh_train_steps(torch, SEED, images[:half], masks[:half], mesh, False)}
    # float32 on MESH_F32_ROWS split over the ranks: sync_bn, and one step
    # on the same rows with each rank's own statistics (sync_bn = false:
    # with the configured Lovasz, a mean over images, that step differs
    # from the synchronized one in its batch statistics alone).
    for kind, sync, steps in (("sync-f32", True, MESH_TRAIN_STEPS), ("local-f32", False, 1)):
        runs[kind] = mesh_train_steps(torch, SEED, shard_batch(mesh, f32_images), shard_batch(mesh, f32_masks), mesh,
                                      sync, dtype=torch.float32, steps=steps)
    if mesh.rank == 0:
        for kind, (losses, bn, flat) in runs.items():
            np.savez(os.path.join(mdir, "train-{}.npz".format(kind)), losses=np.asarray(losses), bn=bn, flat=flat)
    del runs
    lap(marks, "phase 14: [14b] rank {} train steps".format(mesh.rank))

    result = train.main(mesh_train_args(work, train_root, "train-mesh"))
    out["train_history"], out["train_steps"] = result["history"], result["steps"]
    lap(marks, "phase 14: [14b] rank {} train.main".format(mesh.rank))

    counted = wrappers()
    for fn in counted.values():
        fn.launches = 0
    predict.main(predict_args(work, os.path.join(work, "tiles"), os.path.join(mdir, "probs-mesh"),
                              os.path.join(mdir, "model-unet-mesh.toml"), checkpoint))
    out["predict_launches"] = {name: fn.launches for name, fn in counted.items() if fn.launches}
    # predict.main's kernels at its shape (its first batch's rows of this
    # rank, calibrated on the whole batch) against their plain versions.
    rows = shard_batch(mesh, mesh_first_batch(torch, work))
    params, state, _ = load_model_checkpoint(checkpoint, device=mesh.device)
    step, qtree = make_int8_predict_step(unet, params, state, rows, overlap=OVERLAP, host_s2d=True,
                                         calib_percentile=None, mesh=mesh)
    got, ref = step(qtree, rows), step(qtree, rows, plain=True)
    flips, err = u8_flips(torch, got, ref)
    out["int8_rows"] = {"shape": list(rows.shape), "flips": flips, "bins": got.numel(), "max_err": err,
                        "ms": cuda_ms(torch, lambda: step(qtree, rows), [()], 5),
                        "plain_ms": cuda_ms(torch, lambda: step(qtree, rows, plain=True), [()], 2)}
    if err > 1 or flips > MAX_FLIP_SHARE * got.numel():
        raise AssertionError("phase 14: [14b] rank {} int8 step vs the plain step: {}".format(mesh.rank,
                                                                                              out["int8_rows"]))
    del params, state, step, qtree, got, ref
    lap(marks, "phase 14: [14b] rank {} predict.main".format(mesh.rank))
    with open(os.path.join(mdir, "gloo{}.json".format(mesh.rank)), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def int_mm_ms(torch, arg_sets):
    """torch._int_mm's milliseconds over (xq, wq) pairs, or None where its
    constraints refuse the shape."""
    try:
        return cuda_ms(torch, lambda a, w: torch._int_mm(a, w), arg_sets, 10)
    except RuntimeError:
        return None


def segformer_kernels(torch, work, tiles_dir, checkpoint, model_toml, config, per_kernel, smi):
    """Phase 12a: the first predict batch (8 host-blocked 576-px tiles)
    through SegFormer's float32 calibration walk, which keeps every site's
    input; then each of the 54 int8 sites on that input with the calibrated
    scale, against its plain version (bf16 bit-equal): the 51 dense and SR
    sites through `int8_mm.int8_dense` (the quantize kernel, then K2's
    dequant epilogue; the quantized input equal to quantize_act_plain's),
    the 3 patch embeds through rs_int8_conv (conv_kernel). Each distinct
    shape is timed once, as phase 3 times its kernels: K2 alone on the
    quantized input beside torch._int_mm's product at the same (M, K, N),
    the quantize kernel alone, rs_int8_conv; sites that repeat a shape are
    checked and not timed again."""
    from robosat_tpu_torch.checkpoint import load_model_checkpoint
    from robosat_tpu_torch.data.loader import batches
    from robosat_tpu_torch.models import int8 as q8
    from robosat_tpu_torch.models import qconv, segformer
    from robosat_tpu_torch.ops import int8_mm
    from robosat_tpu_torch.parallel.steps import _normalize_s2d4
    from robosat_tpu_torch.tools import predict

    common = config["common"]
    pargs = predict_args(work, tiles_dir, None, model_toml, checkpoint)
    directory, _ = predict.input_directory(pargs, predict.host_s2d_input(common, pargs))
    raw48 = next(iter(batches(directory, BATCH, workers=2))).arrays[0]
    side = (TILE + 2 * OVERLAP) // 4
    if raw48.shape != (BATCH, side, side, 48):
        raise AssertionError("phase 12: first batch has shape {}".format(raw48.shape))
    params, state, _ = load_model_checkpoint(checkpoint, device=torch.device("cuda"))
    percentile = q8.calibration_spec(common.get("int8_calibration", 99.8))
    with torch.no_grad():
        folded = segformer.fold(params, state)
        x48 = _normalize_s2d4(torch.as_tensor(raw48).cuda())
        walk = SiteInputs(q8._Sites(scales=None, percentile=percentile), torch.bfloat16)
        segformer._walk_int8(segformer._float_tree_for_calibration(folded), x48.float(), walk, float_mode=True,
                             blocked=True)
        amaxes = torch.stack(walk.sites.taps).float().cpu()
        if not torch.equal(amaxes, segformer.calibration_amaxes_int8(folded, x48, blocked=True,
                                                                     percentile=percentile)):
            raise AssertionError("phase 12: the calibration walk is not reproducible on the card")
        scales = [float(v) for v in q8.scales_from_amaxes(amaxes)]
        qtree = segformer.quantize_folded_int8(folded)
        segformer.prepare_int8(qtree, scales)
    del params, state, folded, x48
    sites = segformer.sites(qtree)
    if not len(sites) == len(scales) == len(walk.inputs) == 54:
        raise AssertionError("phase 12: {} sites, {} scales, {} inputs".format(len(sites), len(scales),
                                                                             len(walk.inputs)))
    log("phase 12: [12a] float32 calibration of {} sites on {} x {} (int8_calibration = {})".format(
        len(scales), BATCH, raw48.shape[1:], common.get("int8_calibration", 99.8)))
    timed = {}
    with torch.no_grad():
        for (name, node, route, stride), x, scale in zip(sites, walk.inputs, scales):
            site = name + " (segformer)"
            if route == "conv":
                kargs = (x, node, scale, stride, 1, ((1, 1), (1, 1)), "linear")
                routes = dict(qconv.int8_conv.by_route)
                got, ref = qconv.int8_conv(*kargs), qconv.int8_conv_plain(*kargs)
                torch.cuda.synchronize()
                if got.shape != ref.shape or not torch.equal(got, ref):
                    raise AssertionError("phase 12: int8_conv {}: {} vs plain {}, max |diff| {}".format(
                        name, tuple(got.shape), tuple(ref.shape), float((got.float() - ref.float()).abs().max())))
                if qconv.int8_conv.by_route != {**routes, "conv_kernel": routes["conv_kernel"] + 1}:
                    raise AssertionError("phase 12: int8_conv {} did not take conv_kernel".format(name))
                arg_sets = rotated(torch, kargs)
                ms = cuda_ms(torch, qconv.int8_conv, arg_sets, 20)
                dev_ms = device_ms(torch, qconv.int8_conv, arg_sets, 20)
                plain_ms = cuda_ms(torch, qconv.int8_conv_plain, arg_sets, 2)
                del arg_sets
                work_ = site_work("int8_conv", kargs, got)
                bound_ms, bound_by = record(per_kernel, "int8_conv", site, x.shape, 0.0, ms, plain_ms, work_,
                                            device_ms=dev_ms, tops=work_[1] / (dev_ms or ms) / 1e9,
                                            kernel="conv_kernel")
                log("phase 12: [12a] int8_conv {} 3x3 stride 2 on conv_kernel {} -> {}: bit-equal; kernel {:.4f} ms "
                    "(events), {} (device), plain {:.3f} ms, bound {:.4f} ms ({}); {}".format(
                        name, tuple(x.shape), tuple(got.shape), ms,
                        "not measured" if dev_ms is None else "{:.4f} ms".format(dev_ms), plain_ms, bound_ms, bound_by,
                        smi))
                continue
            got, ref = int8_mm.int8_dense(x, node, scale, stride), int8_mm.int8_dense_plain(x, node, scale, stride)
            xq = int8_mm.quantize_act(x, scale, stride)
            torch.cuda.synchronize()
            if got.shape != ref.shape or not torch.equal(got.view(torch.int16), ref.view(torch.int16)):
                raise AssertionError("phase 12: dense {}: {} vs plain {}, {} values differ".format(
                    name, tuple(got.shape), tuple(ref.shape), int((got != ref).sum())))
            if not torch.equal(xq, int8_mm.quantize_act_plain(x, scale, stride)):
                raise AssertionError("phase 12: the quantize kernel at {} differs from its plain version".format(name))
            wq, sc, b = int8_mm.dense_operands(node, scale)
            a = xq.reshape(-1, xq.shape[-1])
            (m, k), n = a.shape, wq.shape[1]
            key = ("dense", m, k, n, tuple(x.shape), stride)
            if key in timed:
                log("phase 12: [12a] K2 {} (M, K, N) = {}: bit-equal (timed as {})".format(name, (m, k, n), timed[key]))
                continue
            timed[key] = name
            arg_sets = rotated(torch, (a, wq, sc, b))
            ms = cuda_ms(torch, int8_mm.int8_matmul_dequant, arg_sets, 10)
            dev_ms = device_ms(torch, int8_mm.int8_matmul_dequant, arg_sets, 10)
            plain_ms = cuda_ms(torch, int8_mm.int8_matmul_dequant_plain, arg_sets, 1)
            lib_ms = int_mm_ms(torch, [args[:2] for args in arg_sets])
            del arg_sets
            moved, ops = nbytes(a, wq, sc, b) + 2 * m * n, 2 * m * k * n
            t = dev_ms or ms
            bound_ms, bound_by = record(per_kernel, "K2", site, (m, k, n), 0.0, ms, plain_ms, (moved, ops, "int8"),
                                        library_ms=lib_ms, device_ms=dev_ms, gbs=moved / t / 1e6, tops=ops / t / 1e9,
                                        share_of_bound=bound(moved, ops, "int8")[0] / t, epilogue="dequant",
                                        stride=stride)
            q_sets = rotated(torch, (x, scale, stride))
            q_ms = cuda_ms(torch, int8_mm.quantize_act, q_sets, 10)
            q_dev = device_ms(torch, int8_mm.quantize_act, q_sets, 10)
            q_plain = cuda_ms(torch, int8_mm.quantize_act_plain, q_sets, 2)
            del q_sets
            q_bound, q_by = record(per_kernel, "quantize", site, x.shape, 0.0, q_ms, q_plain,
                                   (nbytes(x, xq), x.numel(), "f32"), device_ms=q_dev, stride=stride)
            log("phase 12: [12a] K2 {} (M, K, N) = {}{}: bit-equal; kernel {:.4f} ms (events), {} (device), {:.0f} "
                "GB/s, {:.1f} TOP/s, {:.1%} of its bound; _int_mm {}, plain {:.3f} ms, bound {:.4f} ms ({}); "
                "quantize {} -> {}: {:.4f} ms (events), {} (device), plain {:.3f} ms, bound {:.4f} ms ({}); "
                "{}".format(name, (m, k, n), " (space-to-depth {})".format(stride) if stride > 1 else "", ms,
                            "not measured" if dev_ms is None else "{:.4f} ms".format(dev_ms), moved / t / 1e6,
                            ops / t / 1e9, bound_ms / t,
                            "refused" if lib_ms is None else "{:.4f} ms".format(lib_ms), plain_ms, bound_ms, bound_by,
                            tuple(x.shape), tuple(xq.shape), q_ms,
                            "not measured" if q_dev is None else "{:.4f} ms".format(q_dev), q_plain, q_bound, q_by,
                            smi))
    del walk, qtree, got, ref


def family_train_step(torch, seed, config, smi, model, prefix):
    """Phase 11c or 12c (log `prefix`): the family TOML's train step as it
    stands (bf16, its loss, batch 64 at 512 px, augmentation on) from
    `model.init`, on one learnable batch, timed by `time_train_steps` (with
    remat = true instead, said so, if the batch does not fit). Returns the
    numbers."""
    from robosat_tpu_torch import optim
    from robosat_tpu_torch.checkpoint import from_jax, to_jax
    from robosat_tpu_torch.ops.losses import get_loss
    from robosat_tpu_torch.parallel.steps import make_train_step

    common, opt = config["common"], config["opt"]
    batch, size = common["batch_size"], common["image_size"]
    dtype = torch.bfloat16 if common.get("bf16", False) else torch.float32
    weight = PARKING_WEIGHTS if opt["loss"] != "Lovasz" else None
    images, masks = learnable_batches(np.random.default_rng(seed + 11), 1, batch, size)[0]
    images, masks = torch.from_numpy(images).pin_memory(), torch.from_numpy(masks).pin_memory()
    params0, state0 = model.init(seed)
    remat = common.get("remat", False)

    def attempt(remat):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params, state = from_jax(to_jax(params0), to_jax(state0), "cuda")
        step = make_train_step(model, get_loss(opt["loss"]), optim.adam(params, opt["lr"]), weight=weight,
                               compute_dtype=dtype, remat=remat)
        return time_train_steps(torch, prefix, step, params, state, (), images, masks, seed, opt["loss"], dtype,
                                TRAIN_KERNEL_GROUPS, smi)[0]

    try:
        result, oom = attempt(remat), None
    except torch.cuda.OutOfMemoryError as exc:
        if remat:
            raise
        oom = str(exc).splitlines()[0][:160]
    if oom is not None:  # retried outside the handler, whose traceback holds the first attempt's tensors
        log("{} batch {} at {} px does not fit without remat ({}); running remat = true".format(prefix, batch, size,
                                                                                               oom))
        remat = True
        result = attempt(remat)
    result["remat"] = remat
    log("{} {}".format(prefix, json.dumps(result)))
    return result


def family_tools(torch, work, root, base, counted, launches, by_path, smi, model, phase, per_batch):
    """Phase 11c's or 12c's (`phase`) tools, on the dataset at `root`:
    `train.main` with the family TOML `base` (batch TOOL_BATCH) for one
    epoch, then int8 `predict` (TRAINED_CALIBRATION) from its checkpoint over the
    training tiles (`per_batch` launches a batch: DeepLab's 14 K3, 2 K4 and
    7 rs_int8_conv; SegFormer's 51 quantize and K2, 3 rs_int8_conv)."""
    from robosat_tpu_torch.checkpoint import load_checkpoint
    from robosat_tpu_torch.config import load_config, save_config
    from robosat_tpu_torch.tools import train

    name = base["common"]["model"]
    prefix = "phase {}: [{}c".format(phase, phase)
    dataset = load_config(os.path.join(ROOT, "config", "dataset-parking.toml"))
    dataset["common"]["dataset"] = root
    dataset_toml = os.path.join(work, "dataset-{}.toml".format(name))
    save_config(dataset, dataset_toml)
    ckpt_dir = os.path.join(work, "train-{}".format(name))
    config = {**base, "common": {**base["common"], "batch_size": TOOL_BATCH, "checkpoint": ckpt_dir},
              "opt": {**base["opt"], "epochs": 1}}
    model_toml = os.path.join(work, "model-{}-train.toml".format(name))
    save_config(config, model_toml)
    args = argparse.Namespace(model=model_toml, dataset=dataset_toml, checkpoint=None, resume=False, workers=4,
                              profile=None)
    start = time.perf_counter()
    out = train.main(args)
    wall = time.perf_counter() - start
    steps = TRAIN_TILES_SIDE ** 2 // TOOL_BATCH
    checkpoint = os.path.join(ckpt_dir, "checkpoint-00001-of-00001.npz")
    trees, meta = load_checkpoint(checkpoint)
    count = int(trees["opt_state"][0])
    losses = out["history"].get("train loss", [])
    if out["steps"] != steps or count != steps or set(trees["params"]) != set(model.init(0)[0]) \
            or not all(math.isfinite(v) for v in losses):
        raise AssertionError("{}c train: steps {}, count {}, params {}, history {}".format(
            phase, out["steps"], count, sorted(trees["params"]), out["history"]))
    log("{} train] one epoch, batch {}: {} steps in {:.2f} s on {}; {} (opt_state count {}); history {}".format(
        prefix, TOOL_BATCH, out["steps"], wall, smi, os.path.basename(checkpoint), count, out["history"]))
    label = "deeplab" if name == "deeplabv3plus" else name
    counts, pngs, wall, n_batches = predict_split_tiles(root, os.path.join(work, "probs-{}-trained".format(name)),
                                                        checkpoint, counted, "{}c predict".format(phase),
                                                        model_toml=os.path.join(work, "model-{}.toml".format(name)),
                                                        per_batch=per_batch, calibration=TRAINED_CALIBRATION)
    by_path[label + "-train-predict"] = counts
    for kernel, c in counts.items():
        launches[kernel] += c
    log("{} predict] int8 (amax calibration) from the trained checkpoint: {} PNGs in {:.2f} s on {}; launches {} "
        "({} batches)".format(prefix, pngs, wall, smi, counts, n_batches))


def blob_masks(rng, n, size):
    """n binary masks of blobs (some holed) and 1% pepper noise."""
    masks = np.zeros((n, size, size), np.uint8)
    for i in range(n):
        for _ in range(12):
            x, y = rng.integers(0, size - 40, 2)
            w, h = rng.integers(12, 160, 2)
            masks[i, y : y + h, x : x + w] = 1
            if min(w, h) > 80:
                masks[i, y + 30 : y + h - 30, x + 30 : x + w - 30] = 0
        masks[i] ^= (rng.random((size, size)) < 0.01).astype(np.uint8)
    return masks


def write_label_block(root, seed):
    """A VECTOR_SIDE x VECTOR_SIDE block of TILE-px label tiles at z18
    ("P" PNGs, 0 background, 1 parking, 2 building), drawn on the whole
    block so that lots straddle tile edges; some lots hold a hole, and
    sparse pepper noise of all three labels lies over everything."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    n = VECTOR_SIDE * TILE
    canvas = np.zeros((n, n), np.uint8)
    for _ in range(VECTOR_LOTS):
        x, y = rng.integers(0, n - 60, 2)
        w, h = rng.integers(60, 420, 2)
        canvas[y : y + h, x : x + w] = 1
        if min(w, h) > 200:
            canvas[y + 70 : y + h - 70, x + 70 : x + w - 70] = 0
    for _ in range(VECTOR_BUILDINGS):
        x, y = rng.integers(0, n - 60, 2)
        w, h = rng.integers(14, 60, 2)
        canvas[y : y + h, x : x + w] = 2
    k = n * n // 200
    canvas[rng.integers(0, n, k), rng.integers(0, n, k)] = rng.integers(0, 3, k)
    for i in range(VECTOR_SIDE):
        path = os.path.join(root, "18", str(41920 + i))
        os.makedirs(path, exist_ok=True)
        for j in range(VECTOR_SIDE):
            img = Image.fromarray(canvas[j * TILE : (j + 1) * TILE, i * TILE : (i + 1) * TILE], mode="P")
            img.putpalette([0, 0, 0, 255, 165, 0, 255, 0, 0])
            img.save(os.path.join(path, "{}.png".format(101310 + j)), compress_level=1)
    return VECTOR_SIDE * VECTOR_SIDE


def write_osm(merged_path, out_path):
    """Stand-in "OSM" for dedupe: every other merged feature as it is (a
    duplicate), the rest moved east by 20% or 70% of their width (IoU on
    either side of DEDUPE_THRESHOLD)."""
    with open(merged_path) as f:
        merged = json.load(f)["features"]
    osm = []
    for k, feature in enumerate(merged):
        geom = feature["geometry"]
        if k % 2:
            polys = [geom["coordinates"]] if geom["type"] == "Polygon" else geom["coordinates"]
            xs = [p[0] for p in polys[0][0]]
            shift = (max(xs) - min(xs)) * (0.2 if k % 4 == 1 else 0.7)
            for rings in polys:
                for ring in rings:
                    for p in ring:
                        p[0] += shift
        osm.append({"type": "Feature", "properties": {}, "geometry": geom})
    with open(out_path, "w") as f:
        json.dump({"type": "FeatureCollection", "features": osm}, f)


def run_vector(torch, work, smi, masks_dir=None):
    """Phase 9: the vector tools. 9a, `denoise_grow` on the card against
    the CPU on VECTOR_BATCH blob masks of TILE px with each handler's sizes,
    bit-equal, timed by CUDA events and device time; 9b, `features` (its
    morphology on the card, then on the CPU), `merge` and `dedupe` on
    `masks_dir` (phase 5's masks; parking) and on a generated 16 x 16 block
    of label tiles (parking and building): every GeoJSON the card's run
    writes equal, byte for byte, to the CPU run's. Requires the native
    geometry engine and names the contour tracer. Returns a summary."""
    import cv2

    from robosat_tpu_torch import native
    from robosat_tpu_torch.config import save_config
    from robosat_tpu_torch.device import configure_device
    from robosat_tpu_torch.ops import morphology
    from robosat_tpu_torch.tools import dedupe, features, merge

    start_phase = time.perf_counter()
    device = configure_device(True)
    cpu = torch.device("cpu")
    if native.load() is None or merge._native() is None:
        raise AssertionError("phase 9: the native geometry engine did not load")
    tracer = "cv2 {} (findContours RETR_TREE + CHAIN_APPROX_SIMPLE, arcLength, approxPolyDP)".format(cv2.__version__)
    log("phase 9: contour tracer {}; native geometry engine {}".format(tracer, os.path.relpath(native._LIB, ROOT)))
    summary = {"contour_tracer": tracer, "card": smi, "morphology": {}, "tools": {}}

    # ---- 9a: denoise + grow on the card vs the CPU ------------------------
    masks = blob_masks(np.random.default_rng(SEED + 9), VECTOR_BATCH, TILE)
    x_cpu = torch.from_numpy(masks)
    x = x_cpu.to(device)
    for kind, (d, g) in MORPH_SIZES.items():
        want = morphology.denoise_grow(x_cpu, d, g)
        got = morphology.denoise_grow(x, d, g)
        if not torch.equal(got.cpu(), want):
            raise AssertionError("9a [{}]: denoise_grow on the card differs from the CPU on {} pixels".format(
                kind, int((got.cpu() != want).sum())))
        args = rotated(torch, (x, d, g))
        ms = cuda_ms(torch, morphology.denoise_grow, args, 20)
        dev = device_ms(torch, morphology.denoise_grow, args, 10, rows=None)
        # The dense float32 correlations this design runs: 4 convs, each
        # k*k multiply-adds a pixel; uint8 masks in and out.
        ops = 2 * masks.size * 2 * (d * d + g * g)
        b_ms, b_by = bound(2 * masks.size, ops, "f32")
        summary["morphology"][kind] = {"shape": list(masks.shape), "sizes": [d, g], "ms": ms, "device_ms": dev,
                                       "bound_ms": b_ms, "bound_by": b_by, "foreground": float(want.float().mean())}
        log("phase 9: [9a] denoise_grow {} ({}/{}) on {} x {}: bit-equal to the CPU; {:.4f} ms (events), {} "
            "(device), bound of its float32 correlations {:.4f} ms ({}) on {}".format(
                kind, d, g, VECTOR_BATCH, masks.shape[1:], ms,
                "not measured" if dev is None else "{:.4f} ms".format(dev), b_ms, b_by, smi))
    del x, args
    torch.cuda.empty_cache()

    # ---- 9b: features -> merge -> dedupe, card vs CPU ---------------------
    dataset = os.path.join(work, "dataset-vector.toml")
    save_config({"common": {"dataset": work, "classes": ["background", "parking", "building"],
                            "colors": ["denim", "orange", "red"]}}, dataset)
    block = os.path.join(work, "labels-vector")
    start = time.perf_counter()
    n_block = write_label_block(block, SEED)
    log("phase 9: [9b] wrote {} label tiles of {} px in {:.2f} s".format(n_block, TILE, time.perf_counter() - start))
    sources = ([("phase-5-masks", masks_dir, ("parking",))] if masks_dir else []) + [
        ("block-{0}x{0}".format(VECTOR_SIDE), block, ("parking", "building"))]
    real_denoise_grow = features.denoise_grow
    for source, mdir, kinds in sources:
        for kind in kinds:
            run = {}
            osm = os.path.join(work, "vector", "{}-{}-osm.geojson".format(source, kind))
            for name, dev in (("cuda", device), ("cpu", cpu)):
                out = os.path.join(work, "vector", source, kind, name)
                os.makedirs(out, exist_ok=True)
                paths = {stage: os.path.join(out, stage + ".geojson") for stage in ("features", "merged", "deduped")}
                morph = [0.0]

                def timed(masks, d, g, _dev=dev, _morph=morph):
                    if _dev.type == "cuda":
                        torch.cuda.synchronize()
                    t = time.perf_counter()
                    result = real_denoise_grow(masks, d, g)
                    if _dev.type == "cuda":
                        torch.cuda.synchronize()
                    _morph[0] += time.perf_counter() - t
                    return result

                features.denoise_grow = timed
                try:
                    t0 = time.perf_counter()
                    features.main(argparse.Namespace(type=kind, masks=mdir, out=paths["features"], dataset=dataset,
                                                     chunk=16), device=dev)
                finally:
                    features.denoise_grow = real_denoise_grow
                t1 = time.perf_counter()
                merge.main(argparse.Namespace(features=paths["features"], threshold=MERGE_THRESHOLD,
                                              out=paths["merged"]))
                t2 = time.perf_counter()
                if name == "cuda":
                    write_osm(paths["merged"], osm)
                dedupe.main(argparse.Namespace(osm=osm, predicted=paths["merged"], threshold=DEDUPE_THRESHOLD,
                                               out=paths["deduped"]))
                t3 = time.perf_counter()
                run[name] = {"seconds": {"features": t1 - t0, "merge": t2 - t1, "dedupe": t3 - t2},
                             "morphology_s": morph[0], "bytes": {}}
                for stage, path in paths.items():
                    with open(path, "rb") as f:
                        run[name]["bytes"][stage] = f.read()
            counts = {}
            for stage in ("features", "merged", "deduped"):
                if run["cuda"]["bytes"][stage] != run["cpu"]["bytes"][stage]:
                    raise AssertionError("9b [{} {}]: the card's {} GeoJSON differs from the CPU run's".format(
                        source, kind, stage))
                counts[stage] = len(json.loads(run["cuda"]["bytes"][stage])["features"])
            if counts["features"] == 0 and mdir == block:
                raise AssertionError("9b [{} {}]: no features".format(source, kind))
            card = run["cuda"]
            total = sum(card["seconds"].values())
            entry = {"features": counts, "seconds_card": card["seconds"], "morphology_s_card": card["morphology_s"],
                     "morphology_share_of_features": card["morphology_s"] / card["seconds"]["features"],
                     "morphology_share_of_three": card["morphology_s"] / total,
                     "seconds_cpu": run["cpu"]["seconds"], "morphology_s_cpu": run["cpu"]["morphology_s"]}
            summary["tools"]["{} {}".format(source, kind)] = entry
            log("phase 9: [9b] {} {}: features {} -> merged {} -> deduped {}, each GeoJSON byte-equal to the CPU "
                "run's; card s features {:.3f} (morphology {:.3f}, {:.1%}) merge {:.3f} dedupe {:.3f}, "
                "morphology {:.1%} of the three; CPU run s features {:.3f} (morphology {:.3f}) on {}".format(
                    source, kind, counts["features"], counts["merged"], counts["deduped"],
                    card["seconds"]["features"], card["morphology_s"], entry["morphology_share_of_features"],
                    card["seconds"]["merge"], card["seconds"]["dedupe"], entry["morphology_share_of_three"],
                    run["cpu"]["seconds"]["features"], run["cpu"]["morphology_s"], smi))
    summary["seconds"] = time.perf_counter() - start_phase
    log("phase 9: done in {:.1f} s".format(summary["seconds"]))
    return summary


def _varint(n):
    out = bytearray()
    while True:
        b, n = n & 0x7F, n >> 7
        out.append(b | 0x80 if n else b)
        if not n:
            return bytes(out)


def _zigzag(n):
    return (n << 1) if n >= 0 else ((-n) << 1) - 1


def _field(num, wire, payload):
    """A protobuf field: a varint (wire 0) or length-delimited bytes (wire 2)."""
    key = _varint((num << 3) | wire)
    return key + _varint(payload) if wire == 0 else key + _varint(len(payload)) + payload


def _packed(values, signed):
    return b"".join(_varint(_zigzag(v) if signed else v) for v in values)


def _deltas(values):
    return [b - a for a, b in zip([0] + values[:-1], values)]


def _blob(kind, block, compress):
    import struct
    import zlib

    blob = _field(2, 0, len(block)) + _field(3, 2, zlib.compress(block)) if compress else _field(1, 2, block)
    header = _field(1, 2, kind) + _field(3, 0, len(blob))
    return struct.pack(">i", len(header)) + header + blob


def encode_pbf(nodes, ways, gran=100, lat_off=0, lon_off=0):
    """.osm.pbf bytes: a header blob, then the first half of the nodes as
    plain Node messages (raw blob) and the rest as DenseNodes with the ways
    (zlib blob). `nodes` maps id -> (lon, lat) degrees; `ways` lists (id,
    tags, refs)."""
    strings = [""]
    for _, tags, _ in ways:
        for kv in tags.items():
            strings += [s for s in kv if s not in strings]
    index = {s: i for i, s in enumerate(strings)}
    table = _field(1, 2, b"".join(_field(1, 2, s.encode()) for s in strings))
    params = _field(17, 0, gran) + _field(19, 0, lat_off) + _field(20, 0, lon_off)

    def units(deg, off):
        return int(round((deg * 1e9 - off) / gran))

    ids = sorted(nodes)
    plain, dense = ids[: len(ids) // 2], ids[len(ids) // 2 :]
    plain_group = b"".join(
        _field(1, 2, _field(1, 0, _zigzag(i)) + _field(8, 0, _zigzag(units(nodes[i][1], lat_off)))
               + _field(9, 0, _zigzag(units(nodes[i][0], lon_off))))
        for i in plain)
    dense_msg = (_field(1, 2, _packed(_deltas(dense), True))
                 + _field(8, 2, _packed(_deltas([units(nodes[i][1], lat_off) for i in dense]), True))
                 + _field(9, 2, _packed(_deltas([units(nodes[i][0], lon_off) for i in dense]), True)))
    way_msgs = b"".join(
        _field(3, 2, _field(1, 0, wid) + _field(2, 2, _packed([index[k] for k in tags], False))
               + _field(3, 2, _packed([index[v] for v in tags.values()], False))
               + _field(8, 2, _packed(_deltas(refs), True)))
        for wid, tags, refs in ways)
    header = _blob(b"OSMHeader", _field(4, 2, b"OsmSchema-V0.6"), compress=False)
    first = _blob(b"OSMData", table + _field(2, 2, plain_group) + params, compress=False)
    second = _blob(b"OSMData", table + _field(2, 2, _field(2, 2, dense_msg)) + _field(2, 2, way_msgs) + params,
                   compress=True)
    return header + first + second


def encode_xml(nodes, ways):
    """The same map as .osm XML, each coordinate written as repr() of its float."""
    from xml.sax.saxutils import quoteattr

    out = ['<?xml version="1.0"?>', '<osm version="0.6">']
    out += ['<node id="{}" lat="{!r}" lon="{!r}"/>'.format(i, lat, lon) for i, (lon, lat) in sorted(nodes.items())]
    for wid, tags, refs in ways:
        out.append('<way id="{}">'.format(wid))
        out += ['<nd ref="{}"/>'.format(r) for r in refs]
        out += ["<tag k={} v={}/>".format(quoteattr(k), quoteattr(v)) for k, v in tags.items()]
        out.append("</way>")
    return "\n".join(out + ["</osm>"]) + "\n"


def workflow_map(seed):
    """Phase 10's map over the WORKFLOW_SIDE^2 block of z18 tiles: WORKFLOW_LOTS
    closed parking ways (parallelograms inside the block), ways the parking
    filter drops (3 underground, 3 unclosed, one bow-tie), 6 buildings and
    4 highways. Returns (nodes in degrees, ways, the lots' corners). Each
    coordinate is the float the PBF reader decodes from it (1e-9 * (100 *
    units) at granularity 100), so the XML and the PBF hold one map."""
    from robosat_tpu_torch.geo import tilemath

    rng = np.random.default_rng(seed)
    west, _, _, north = tilemath.bounds(tilemath.Tile(WORKFLOW_X0, WORKFLOW_Y0, 18))
    _, south, east, _ = tilemath.bounds(tilemath.Tile(WORKFLOW_X0 + WORKFLOW_SIDE - 1,
                                                      WORKFLOW_Y0 + WORKFLOW_SIDE - 1, 18))
    nodes, ways, corners = {}, [], []

    def node(fx, fy):
        """A node at fractions (fx, fy) of the block from its south-west corner."""
        nid = len(nodes) + 1
        nodes[nid] = tuple(1e-9 * (100 * int(round(deg * 1e7)))
                           for deg in (west + fx * (east - west), south + fy * (north - south)))
        return nid

    def parallelogram(w_range, closed=True):
        x, y = rng.uniform(0.03, 0.85, 2)
        w, h = rng.uniform(*w_range, 2)
        s = rng.uniform(-w / 3, w / 3)
        x = max(x, 0.01 - min(s, 0.0))
        refs = [node(x, y), node(x + w, y), node(x + w + s, y + h), node(x + s, y + h)]
        return refs + [refs[0]] if closed else refs

    wid = 1000
    for _ in range(WORKFLOW_LOTS):
        refs = parallelogram((0.02, 0.09))
        corners += [nodes[r] for r in refs]
        ways.append((wid, {"amenity": "parking"}, refs))
        wid += 1
    for k in range(3):
        ways.append((wid, {"amenity": "parking", "parking": "underground"}, parallelogram((0.02, 0.05))))
        ways.append((wid + 1, {"amenity": "parking"}, parallelogram((0.02, 0.05), closed=False)))
        wid += 2
    a, b, c, d = node(0.5, 0.5), node(0.55, 0.55), node(0.55, 0.5), node(0.5, 0.55)
    ways.append((wid, {"amenity": "parking"}, [a, b, c, d, a]))  # a bow-tie: invalid, dropped
    wid += 1
    for _ in range(6):
        ways.append((wid, {"building": "yes"}, parallelogram((0.005, 0.015))))
        wid += 1
    for tags in ({"highway": "residential"}, {"highway": "service"}, {"highway": "primary", "oneway": "yes"},
                 {"highway": "tertiary", "lanes": "3"}):
        y = rng.uniform(0.1, 0.9)
        ways.append((wid, tags, [node(0.05, y), node(0.5, y + rng.uniform(-0.05, 0.05)), node(0.95, y)]))
        wid += 1
    return nodes, ways, corners


def workflow_imagery(root, tiles, features, seed):
    """Generated TILE-px RGB tiles for `tiles` (z18 Tile ids): a smooth
    texture with noise, the lots of `features` painted in asphalt gray.
    Returns {(x, y): pixels}."""
    from PIL import Image

    from robosat_tpu_torch.tools import rasterize

    rng = np.random.default_rng(seed)
    index = rasterize.features_by_tile(features, 18)
    yy, xx = np.mgrid[0:TILE, 0:TILE].astype(np.float32)
    served = {}
    for tile in tiles:
        phase = rng.uniform(0, 2 * np.pi, 3)
        base = 0.55 + 0.3 * np.stack([np.sin(xx / (29 + 5 * c) + yy / (37 + 3 * c) + phase[c]) for c in range(3)], -1)
        img = base * 255 + rng.normal(0, 10, base.shape)
        covering = index.get(tile)
        if covering:
            lot = rasterize.burn(tile, covering, TILE).astype(bool)
            img[lot] = np.array([72.0, 72.0, 78.0]) + rng.normal(0, 6, (int(lot.sum()), 3))
        img = np.clip(img, 0, 255).astype(np.uint8)
        path = os.path.join(root, "18", str(tile.x))
        os.makedirs(path, exist_ok=True)
        Image.fromarray(img).save(os.path.join(path, "{}.png".format(tile.y)), compress_level=1)
        served[(tile.x, tile.y)] = img
    return served


def tree_bytes(root):
    """{relative path: bytes} of every file under `root`."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            with open(os.path.join(dirpath, name), "rb") as f:
                out[os.path.relpath(os.path.join(dirpath, name), root)] = f.read()
    return out


def read_feature_collection(path):
    """A GeoJSON FeatureCollection's features; raises unless it is one."""
    with open(path) as f:
        collection = json.load(f)
    if collection.get("type") != "FeatureCollection" or not isinstance(collection.get("features"), list):
        raise AssertionError("phase 10: {} is not a GeoJSON FeatureCollection".format(path))
    for feature in collection["features"]:
        if feature.get("type") != "Feature" or feature["geometry"]["type"] not in ("Polygon", "MultiPolygon"):
            raise AssertionError("phase 10: {} holds {}".format(path, feature.get("type")))
    return collection["features"]


def workflow_serve(torch, upstream, served, tiles, checkpoint, model_toml, dataset_toml, stage, smi):
    """Phase 10's serve stage: `serve`'s Predictor on the workflow's
    checkpoint (config/model-unet.toml, the card) behind its handler and a
    local upstream http.server over the workflow's imagery. SERVE_TILES z18
    tiles requested once, then SERVE_REPEATS timed requests over them; every
    PNG mode P, TILE x TILE, indices <= 1; SERVE_COMPARED of them against the
    same segment step on the CPU (equal but at pixels where the CPU's
    |l1 - l0| is below SERVE_TIE of its largest |margin|, at most
    MAX_FLIP_SHARE of the pixels); the 404 of z17 and the 500 of a tile the
    upstream lacks. Returns the stage's numbers."""
    import functools
    import http.server
    import io
    import threading
    import urllib.error
    import urllib.request

    import requests
    from PIL import Image

    from robosat_tpu_torch.checkpoint import load_model_checkpoint
    from robosat_tpu_torch.config import load_config
    from robosat_tpu_torch.device import configure_device
    from robosat_tpu_torch.geo import tilemath
    from robosat_tpu_torch.models import unet
    from robosat_tpu_torch.ops.augment import normalize
    from robosat_tpu_torch.parallel.steps import make_segment_step
    from robosat_tpu_torch.tools import serve

    class Quiet(http.server.SimpleHTTPRequestHandler):
        def log_message(self, *args):
            pass

    t = time.perf_counter()
    predictor = serve.Predictor(checkpoint, load_config(model_toml), load_config(dataset_toml), TILE)
    if predictor.params["final"]["w"].device.type != configure_device(True).type:
        raise AssertionError("phase 10: serve's Predictor runs on {}".format(predictor.params["final"]["w"].device))
    build_s = time.perf_counter() - t
    session = requests.Session()
    session.trust_env = False  # the loopback upstream, off any proxy of the environment
    upstream_server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), functools.partial(Quiet, directory=upstream))
    handler = serve.make_handler(predictor, session, "http://127.0.0.1:{}/{{z}}/{{x}}/{{y}}.png".format(
        upstream_server.server_address[1]), "chip-smoke-token", TILE, 0)
    server = http.server.HTTPServer(("127.0.0.1", 0), handler)
    threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in (upstream_server, server)]
    for thread in threads:
        thread.start()
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    base = "http://127.0.0.1:{}".format(server.server_address[1])

    def get(path):
        try:
            with opener.open(base + path, timeout=120) as resp:
                return resp.status, resp.headers.get("Access-Control-Allow-Origin"), resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.headers.get("Access-Control-Allow-Origin"), b""

    requested = tiles[:SERVE_TILES]
    if len(requested) != SERVE_TILES:
        raise AssertionError("phase 10: {} tiles to serve, expected {}".format(len(requested), SERVE_TILES))
    try:
        pngs, latencies = {}, []
        for k in range(SERVE_TILES + SERVE_REPEATS):
            tile = requested[k % SERVE_TILES]
            start = time.perf_counter()
            code, cors, body = get("/18/{}/{}.png".format(tile.x, tile.y))
            if k >= SERVE_TILES:
                latencies.append((time.perf_counter() - start) * 1e3)
            if code != 200 or cors != "*":
                raise AssertionError("phase 10: serve answered {} (CORS {!r}) for {}".format(code, cors, tile))
            img = Image.open(io.BytesIO(body))
            idx = np.asarray(img)
            if img.mode != "P" or img.size != (TILE, TILE) or idx.max() > 1:
                raise AssertionError("phase 10: serve's PNG for {} is {} {} with indices up to {}".format(
                    tile, img.mode, img.size, idx.max()))
            if tile in pngs and not np.array_equal(pngs[tile], idx):
                raise AssertionError("phase 10: serve answered {} differently on a repeat".format(tile))
            pngs[tile] = idx
        missing = tilemath.Tile(WORKFLOW_X0 - 1, WORKFLOW_Y0 - 1, 18)
        codes = {"z17": get("/17/{}/{}.png".format(tiles[0].x // 2, tiles[0].y // 2))[:2],
                 "missing upstream": get("/18/{}/{}.png".format(missing.x, missing.y))[:2]}
        if codes != {"z17": (404, "*"), "missing upstream": (500, "*")}:
            raise AssertionError("phase 10: serve answered {}".format(codes))
    finally:
        for s in (server, upstream_server):
            s.shutdown()
            s.server_close()
        for thread in threads:
            thread.join(timeout=30)

    # The card's step by CUDA events, then SERVE_COMPARED tiles on the CPU.
    raw = np.stack([served[(tile.x, tile.y)] for tile in requested[:1]])
    step_ms = cuda_ms(torch, predictor.mask, [(raw,)], 16)
    step_wall_ms, step_kernel_ms = kernel_split(torch, lambda: predictor.mask(raw))
    # The step as it was before serve folded once: fold and segment per request.
    refold_ms = cuda_ms(torch, lambda r: predictor.step(predictor.params, predictor.state, r), [(raw,)], 16)
    cpu_params, cpu_state, _ = load_model_checkpoint(checkpoint)
    compared = requested[:SERVE_COMPARED]
    raw = np.stack([served[(tile.x, tile.y)] for tile in compared])
    want = make_segment_step(unet)(cpu_params, cpu_state, raw).numpy()
    with torch.no_grad():
        logits = unet.apply_folded(unet.fold(cpu_params, cpu_state), normalize(torch.from_numpy(raw)))
    margin = (logits[..., 1] - logits[..., 0]).abs().numpy()
    near = margin < SERVE_TIE * margin.max(axis=(1, 2), keepdims=True)
    differ = np.stack([pngs[tile] for tile in compared]) != want
    if (differ & ~near).any():
        raise AssertionError("phase 10: serve's PNGs differ from the CPU's segment step at {} pixels off a "
                             "tie".format(int((differ & ~near).sum())))
    flips, ties = int(differ.sum()), int(near.sum())
    if flips > MAX_FLIP_SHARE * SERVE_COMPARED * TILE * TILE:
        raise AssertionError("phase 10: serve's PNGs differ from the CPU at {} near-tie pixels".format(flips))
    latency = float(np.median(latencies))
    stage("serve", time.perf_counter() - t, predictor_s=round(build_s, 2), tiles=SERVE_TILES,
          timed_requests=len(latencies), median_request_ms=round(latency, 2), step_ms=round(step_ms, 3),
          step_with_fold_ms=round(refold_ms, 3),
          step_profiled_wall_ms=round(step_wall_ms, 3), step_kernel_ms=step_kernel_ms,
          compared_with_cpu=SERVE_COMPARED, near_tie_pixels=ties, differing_pixels=flips, codes=codes)
    return {"median_request_ms": latency, "step_ms": step_ms, "step_with_fold_ms": refold_ms,
            "step_profiled_wall_ms": step_wall_ms,
            "step_kernel_ms": step_kernel_ms, "requests": SERVE_TILES + SERVE_REPEATS, "differing_pixels": flips,
            "near_tie_pixels": ties, "card": smi}


def workflow_export(torch, root, val_images, checkpoint, dataset_toml, counted, stage, smi):
    """Phase 10's export stage: `export` of the workflow's checkpoint as
    pt2 (`logits` and `predict`, batch EXPORT_BATCH at TILE px, traced on
    the card) and as onnx; both programs reloaded and run on the first
    EXPORT_BATCH validation tiles: `logits` against eager `unet.apply`
    (rtol 1e-5, atol 1e-5 of the largest |logit|), `predict` bit-equal to
    the eager `make_predict_step` and, as phase 3 holds K1, off the step
    with the plain head by one bin on at most MAX_FLIP_SHARE of the pixels;
    its graph holding robosat.margin_head,
    its K1 launches counted (every count set to 0 just before the program
    runs and read just after). Returns the stage's numbers and the
    launches."""
    from PIL import Image

    from robosat_tpu_torch.checkpoint import load_model_checkpoint
    from robosat_tpu_torch.device import configure_device
    from robosat_tpu_torch.models import unet
    from robosat_tpu_torch.ops.augment import normalize
    from robosat_tpu_torch.parallel.steps import make_predict_step
    from robosat_tpu_torch.tiles import tiles_from_slippy_map
    from robosat_tpu_torch.tools import export

    t = time.perf_counter()
    device = configure_device(True)
    paths = {"logits": os.path.join(root, "unet-logits.pt2"), "predict": os.path.join(root, "unet-predict.pt2"),
             "onnx": os.path.join(root, "unet.onnx")}
    export_s = {}  # export.main's seconds: the trace and the save (pt2), the fold and the write (onnx)
    for name, path in paths.items():
        start = time.perf_counter()
        export.main(argparse.Namespace(dataset=dataset_toml, image_size=TILE, checkpoint=checkpoint,
                                       batch_size=EXPORT_BATCH, graph="logits" if name == "onnx" else name,
                                       family="unet", format="onnx" if name == "onnx" else "pt2", model=path))
        export_s[name] = time.perf_counter() - start
    sizes = {name: os.path.getsize(path) for name, path in paths.items()}
    loaded = {name: torch.export.load(paths[name]) for name in ("logits", "predict")}
    programs = {name: program.module() for name, program in loaded.items()}
    nodes = [n for n in loaded["predict"].graph.nodes
             if n.op == "call_function" and "robosat.margin_head" in str(n.target)]
    if len(nodes) != 1:
        raise AssertionError("phase 10: the predict program holds {} robosat.margin_head nodes".format(len(nodes)))
    val = sorted(tiles_from_slippy_map(val_images))[:EXPORT_BATCH]
    if len(val) != EXPORT_BATCH:
        raise AssertionError("phase 10: {} validation tiles for a batch of {}".format(len(val), EXPORT_BATCH))
    raw = torch.from_numpy(np.stack([np.asarray(Image.open(path).convert("RGB")) for _, path in val])).to(device)

    # The predict program, as the main path: launches counted over one batch.
    for fn in counted.values():
        fn.launches = 0
    got = programs["predict"](raw)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counted.items() if fn.launches}
    if launches != EXPORT_LAUNCHES:
        raise AssertionError("phase 10: the predict program launched {}, expected {}".format(launches,
                                                                                           EXPORT_LAUNCHES))
    params, state, _ = load_model_checkpoint(checkpoint, device=device)
    step = make_predict_step(unet, overlap=0, compute_dtype=torch.bfloat16, fused_head=True)
    eager = step(params, state, raw)
    if got.dtype != torch.uint8 or got.shape != (EXPORT_BATCH, TILE, TILE) or not torch.equal(got, eager):
        raise AssertionError("phase 10: the predict program's {} {} is not the eager step's".format(
            got.dtype, tuple(got.shape)))
    # K1 at this path's shape against its plain version: the same step with
    # margin_head_plain, within phase 3's bound (flips by one bin only).
    plain = step(params, state, raw, plain=True)
    k1_flips, k1_err = u8_flips(torch, got, plain)
    if k1_err > 1 or k1_flips > MAX_FLIP_SHARE * got.numel():
        raise AssertionError("phase 10: the predict program's K1 flips {} bins of its plain head (max distance "
                             "{})".format(k1_flips, k1_err))
    x = normalize(raw)
    with torch.no_grad():
        want, _ = unet.apply(params, state, x, train=False)
    logits = programs["logits"](x)
    err = float((logits - want).abs().max())
    torch.testing.assert_close(logits, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    # The program and the eager step in turns (program, eager, eager, program): events, then the profiler.
    times = {"program": [], "eager": []}
    split = {}
    for name in ("program", "eager", "eager", "program"):
        fn = programs["predict"] if name == "program" else (lambda r: step(params, state, r))
        times[name].append(cuda_ms(torch, fn, [(raw,)], 10))
        if name not in split:
            split[name] = kernel_split(torch, lambda: fn(raw))
    stage("export", time.perf_counter() - t, export_s={k: round(v, 2) for k, v in export_s.items()},
          bytes=sizes, predict_program_ms=[round(v, 3) for v in times["program"]],
          eager_step_ms=[round(v, 3) for v in times["eager"]],
          profiled_wall_and_kernel_ms={k: [round(v, 3) if v else v for v in w] for k, w in split.items()},
          batch=EXPORT_BATCH, logits_max_abs_err=err, predict="bit-equal",
          k1_vs_plain="{} of {} bins flipped by 1".format(k1_flips, got.numel()), launches=launches)
    return {"export_s": export_s, "bytes": sizes, "program_ms": times["program"], "eager_ms": times["eager"],
            "profiled_wall_and_kernel_ms": split, "logits_max_abs_err": err, "k1_flips_vs_plain": k1_flips,
            "launches": launches, "card": smi}


def run_workflow(torch, work, seed, smi, counted):
    """Phase 10: the README's workflow on robosat_tpu_torch alone, each
    stage a call of the tool's `main`: a generated map as .osm XML and
    .osm.pbf -> extract (both files; parking, building, road) -> cover ->
    download (a local http.server; it needs `requests`) -> rasterize
    (twice) -> subset (training, validation) -> weights -> train (the card,
    one epoch) -> int8 predict (the card, launches counted) -> masks ->
    features (the card) -> merge -> dedupe -> compare. Every check raises.
    Returns a summary with the stage seconds and the predict launches."""
    import contextlib
    import functools
    import http.server
    import io
    import threading

    from PIL import Image

    from robosat_tpu_torch.config import load_config, save_config
    from robosat_tpu_torch.geo import tilemath
    from robosat_tpu_torch.tiles import tiles_from_csv, tiles_from_slippy_map
    from robosat_tpu_torch.tools import (compare, cover, dedupe, download, extract, features, masks, merge,
                                         rasterize, subset, train, weights)

    root = os.path.join(work, "workflow")
    os.makedirs(root)
    summary = {"card": smi, "stages": {}}
    start_phase = time.perf_counter()

    def stage(name, seconds, **counts):
        summary["stages"][name] = {"seconds": seconds, **counts}
        log("phase 10: [{}] {:.2f} s; {} on {}".format(
            name, seconds, ", ".join("{} {}".format(k.replace("_", " "), v) for k, v in counts.items()), smi))

    # 1. the map, twice
    t = time.perf_counter()
    nodes, ways, corners = workflow_map(seed)
    with open(os.path.join(root, "map.osm.pbf"), "wb") as f:
        f.write(encode_pbf(nodes, ways))
    with open(os.path.join(root, "map.osm"), "w") as f:
        f.write(encode_xml(nodes, ways))
    stage("map", time.perf_counter() - t, nodes=len(nodes), ways=len(ways), lots=WORKFLOW_LOTS,
          pbf_bytes=os.path.getsize(os.path.join(root, "map.osm.pbf")))

    # 2. extract
    t = time.perf_counter()
    extracted = {}
    for kind, maps in (("parking", ("map.osm.pbf", "map.osm")), ("building", ("map.osm.pbf",)),
                       ("road", ("map.osm.pbf",))):
        for name in maps:
            out = os.path.join(root, "extract", name.replace(".", "-"), kind + ".geojson")
            os.makedirs(os.path.dirname(out), exist_ok=True)
            extract.main(argparse.Namespace(type=kind, batch=100000, map=os.path.join(root, name), out=out))
            chunks = [os.path.join(os.path.dirname(out), c) for c in sorted(os.listdir(os.path.dirname(out)))
                      if c.startswith(kind + "-")]
            extracted[(kind, name)] = [read_feature_collection(c) for c in chunks]
    parking_pbf, parking_xml = extracted[("parking", "map.osm.pbf")], extracted[("parking", "map.osm")]
    if parking_pbf != parking_xml or len(parking_pbf) != 1 or len(parking_pbf[0]) != WORKFLOW_LOTS:
        raise AssertionError("phase 10: extract --type parking: {} from the PBF, {} from the XML, expected one chunk "
                             "of {} lots, equal".format([len(c) for c in parking_pbf], [len(c) for c in parking_xml],
                                                        WORKFLOW_LOTS))
    counts = {kind: sum(map(len, extracted[(kind, "map.osm.pbf")])) for kind in ("parking", "building", "road")}
    if not counts["building"] or not counts["road"]:
        raise AssertionError("phase 10: extract gave {}".format(counts))
    lots_path = os.path.join(root, "parking.geojson")
    with open(lots_path, "w") as f:
        json.dump({"type": "FeatureCollection", "features": parking_pbf[0]}, f)
    stage("extract", time.perf_counter() - t, parking_pbf_equal_to_xml=True, **counts)

    # 3. cover, plus a lot-free column of tiles east of the block
    t = time.perf_counter()
    covered_csv = os.path.join(root, "cover.csv")
    cover.main(argparse.Namespace(zoom=18, features=lots_path, out=covered_csv))
    covered = set(tiles_from_csv(covered_csv))
    corner_tiles = {tilemath.tile(lon, lat, 18) for lon, lat in corners}
    blank = {tilemath.Tile(WORKFLOW_X0 + WORKFLOW_SIDE, WORKFLOW_Y0 + j, 18) for j in range(WORKFLOW_SIDE)}
    if not corner_tiles <= covered or covered & blank:
        raise AssertionError("phase 10: cover missed {} corner tiles (or covered the blank column: {})".format(
            len(corner_tiles - covered), len(covered & blank)))
    all_tiles = sorted(covered | blank)
    tiles_csv = os.path.join(root, "tiles.csv")
    with open(tiles_csv, "w") as f:
        f.writelines("{},{},{}\n".format(*tile) for tile in all_tiles)
    stage("cover", time.perf_counter() - t, tiles=len(covered), corner_tiles=len(corner_tiles),
          lot_free_tiles=len(blank))

    # 4. imagery, served and downloaded
    t = time.perf_counter()
    upstream = os.path.join(root, "upstream")
    served = workflow_imagery(upstream, all_tiles, parking_pbf[0], seed)
    images = os.path.join(root, "images")

    class Quiet(http.server.SimpleHTTPRequestHandler):
        def log_message(self, *args):
            pass

    t_fetch = time.perf_counter()
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), functools.partial(Quiet, directory=upstream))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    # requests reads proxies from the environment: keep the loopback server off any proxy.
    saved = {k: os.environ.get(k) for k in ("no_proxy", "NO_PROXY")}
    os.environ["no_proxy"] = os.environ["NO_PROXY"] = "127.0.0.1,localhost"
    try:
        url = "http://127.0.0.1:{}/{{z}}/{{x}}/{{y}}.png".format(server.server_address[1])
        download.main(argparse.Namespace(url=url, ext="png", rate=WORKFLOW_RATE, tiles=tiles_csv, out=images))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    t_done = time.perf_counter()
    got = dict(tiles_from_slippy_map(images))
    if sorted(got) != all_tiles:
        raise AssertionError("phase 10: {} image tiles for {} listed".format(len(got), len(all_tiles)))
    for tile, path in got.items():
        if not np.array_equal(np.asarray(Image.open(path)), served[(tile.x, tile.y)]):
            raise AssertionError("phase 10: {} does not decode to the served pixels".format(path))
    stage("download", t_done - t_fetch, rate=WORKFLOW_RATE, tiles=len(got), imagery_written_s=round(t_fetch - t, 2))

    # 5. rasterize, twice
    dataset = load_config(os.path.join(ROOT, "config", "dataset-parking.toml"))
    dataset["common"]["dataset"] = os.path.join(root, "dataset")
    dataset_toml = os.path.join(root, "dataset.toml")
    save_config(dataset, dataset_toml)
    labels = os.path.join(root, "labels")
    t = time.perf_counter()
    rargs = argparse.Namespace(features=lots_path, tiles=tiles_csv, out=labels, dataset=dataset_toml, zoom=18,
                               size=TILE)
    rasterize.main(rargs)
    first_pass = time.perf_counter() - t
    first = tree_bytes(labels)
    rasterize.main(rargs)
    if tree_bytes(labels) != first:
        raise AssertionError("phase 10: rasterize's second pass changed the labels")
    fg = {}
    for tile, path in tiles_from_slippy_map(labels):
        mask = np.asarray(Image.open(path))
        if mask.shape != (TILE, TILE) or Image.open(path).mode != "P":
            raise AssertionError("phase 10: label {} is {} {}".format(path, Image.open(path).mode, mask.shape))
        fg[tile] = int(np.count_nonzero(mask))
    if len(fg) != len(all_tiles) or not any(fg.values()) or any(fg[tile] for tile in blank):
        raise AssertionError("phase 10: labels {} for {} tiles; foreground in the lot-free column: {}".format(
            len(fg), len(all_tiles), [fg.get(tile) for tile in sorted(blank)]))
    stage("rasterize", first_pass, labels=len(fg), with_foreground=sum(v > 0 for v in fg.values()),
          foreground_share=round(sum(fg.values()) / (len(fg) * TILE * TILE), 4), second_pass="byte-equal")

    # 6. subset into training/ and validation/
    t = time.perf_counter()
    splits = {"training": [tile for k, tile in enumerate(all_tiles) if k % 4 != 3],
              "validation": [tile for k, tile in enumerate(all_tiles) if k % 4 == 3]}
    for split, tiles in splits.items():
        csv_path = os.path.join(root, split + ".csv")
        with open(csv_path, "w") as f:
            f.writelines("{},{},{}\n".format(*tile) for tile in tiles)
        for kind, src in (("images", images), ("labels", labels)):
            subset.main(argparse.Namespace(images=src, tiles=csv_path,
                                           out=os.path.join(dataset["common"]["dataset"], split, kind)))
            copied = [tile for tile, _ in tiles_from_slippy_map(os.path.join(dataset["common"]["dataset"], split,
                                                                             kind))]
            if sorted(copied) != sorted(tiles):
                raise AssertionError("phase 10: subset {} {}".format(split, kind))
    stage("subset", time.perf_counter() - t, training=len(splits["training"]), validation=len(splits["validation"]))

    # 7. weights, recomputed from the labels, into the dataset TOML
    t = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        weights.main(argparse.Namespace(dataset=dataset_toml))
    seconds = time.perf_counter() - t
    hist = np.zeros(2, np.int64)
    for _, path in tiles_from_slippy_map(os.path.join(dataset["common"]["dataset"], "training", "labels")):
        hist += np.bincount(np.asarray(Image.open(path)).ravel(), minlength=2)[:2]
    want = (1.0 / np.log(1.02 + hist / hist.sum())).round(6).tolist()
    if out.getvalue().strip() != str(want):
        raise AssertionError("phase 10: weights printed {!r}, 1/ln(1.02 + p) is {}".format(out.getvalue(), want))
    dataset["weights"] = {"values": want}
    save_config(dataset, dataset_toml)
    stage("weights", seconds, values=want, foreground_pixels=int(hist[1]))

    # 8. train on the card, one epoch
    base = load_config(os.path.join(ROOT, "config", "model-unet.toml"))
    ckpt_dir = os.path.join(root, "checkpoints")
    model_toml = os.path.join(root, "model-unet.toml")
    save_config({**base, "common": {**base["common"], "batch_size": WORKFLOW_BATCH, "checkpoint": ckpt_dir},
                 "opt": {**base["opt"], "epochs": 1}}, model_toml)
    t = time.perf_counter()
    result = train.main(argparse.Namespace(model=model_toml, dataset=dataset_toml, checkpoint=None, resume=False,
                                           workers=4, profile=None))
    seconds = time.perf_counter() - t
    checkpoint = os.path.join(ckpt_dir, "checkpoint-00001-of-00001.npz")
    losses = {k: result["history"][k][-1] for k in ("train loss", "val loss")}
    steps = len(splits["training"]) // WORKFLOW_BATCH
    if not os.path.isfile(checkpoint) or not all(map(math.isfinite, losses.values())) or result["steps"] != steps:
        raise AssertionError("phase 10: train wrote {}, losses {}, {} steps (expected {})".format(
            sorted(os.listdir(ckpt_dir)), losses, result["steps"], steps))
    stage("train", seconds, cut="batch_size {} -> {} (the config's {} exceed the {} training tiles)".format(
        base["common"]["batch_size"], WORKFLOW_BATCH, base["common"]["batch_size"], len(splits["training"])),
          steps=result["steps"], train_loss=round(losses["train loss"], 5), val_loss=round(losses["val loss"], 5),
          checkpoint_mb=round(os.path.getsize(checkpoint) / 1e6, 1))

    # 9. int8 predict on the card, through the counted wrappers
    probs = os.path.join(root, "probs")
    counts, pngs, seconds, n_batches = predict_split_tiles(
        dataset["common"]["dataset"], probs, checkpoint, counted, "phase 10: predict", model_toml=model_toml,
        split="validation", tiles=len(splits["validation"]), calibration=TRAINED_CALIBRATION)
    summary["launches"] = counts
    stage("predict", seconds, pngs=pngs, batches=n_batches, launches=counts)

    # 10. masks -> features -> merge -> dedupe, then compare
    masks_dir = os.path.join(root, "masks")
    t = time.perf_counter()
    masks.main(argparse.Namespace(masks=masks_dir, probs=[probs], weights=None))
    n_masks = 0
    for _, path in tiles_from_slippy_map(masks_dir):
        img = Image.open(path)
        img.load()
        if img.mode != "P" or img.size != (TILE, TILE):
            raise AssertionError("phase 10: mask {} is {} {}".format(path, img.mode, img.size))
        n_masks += 1
    if n_masks != len(splits["validation"]):
        raise AssertionError("phase 10: {} masks for {} tiles".format(n_masks, len(splits["validation"])))
    stage("masks", time.perf_counter() - t, masks=n_masks)
    vector = {name: os.path.join(root, name + ".geojson") for name in ("features", "merged", "deduped")}
    t = time.perf_counter()
    features.main(argparse.Namespace(type="parking", masks=masks_dir, out=vector["features"], dataset=dataset_toml,
                                     chunk=16))
    stage("features", time.perf_counter() - t, features=len(read_feature_collection(vector["features"])))
    t = time.perf_counter()
    merge.main(argparse.Namespace(features=vector["features"], threshold=MERGE_THRESHOLD, out=vector["merged"]))
    stage("merge", time.perf_counter() - t, features=len(read_feature_collection(vector["merged"])))
    t = time.perf_counter()
    dedupe.main(argparse.Namespace(osm=lots_path, predicted=vector["merged"], threshold=DEDUPE_THRESHOLD,
                                   out=vector["deduped"]))
    stage("dedupe", time.perf_counter() - t, features=len(read_feature_collection(vector["deduped"])))
    strips = os.path.join(root, "compare")
    val = dataset["common"]["dataset"]
    t = time.perf_counter()
    compare.main(argparse.Namespace(out=strips, images=os.path.join(val, "validation", "images"),
                                    labels=os.path.join(val, "validation", "labels"), masks=[masks_dir],
                                    minimum=0.0, maximum=1.0))
    n_strips = 0
    for _, path in tiles_from_slippy_map(strips):
        img = Image.open(path)
        img.load()
        if img.mode != "RGB" or img.size != (3 * TILE, TILE):
            raise AssertionError("phase 10: strip {} is {} {}".format(path, img.mode, img.size))
        n_strips += 1
    if n_strips != len(splits["validation"]):
        raise AssertionError("phase 10: {} strips for {} tiles".format(n_strips, len(splits["validation"])))
    stage("compare", time.perf_counter() - t, strips=n_strips)

    # 11. serve the checkpoint, then export it
    summary["serve"] = workflow_serve(torch, upstream, served, all_tiles, checkpoint, model_toml, dataset_toml,
                                      stage, smi)
    summary["export"] = workflow_export(torch, root, os.path.join(val, "validation", "images"), checkpoint,
                                        dataset_toml, counted, stage, smi)
    summary["seconds"] = time.perf_counter() - start_phase
    log("phase 10: done in {:.1f} s".format(summary["seconds"]))
    return summary


if __name__ == "__main__":
    main()
