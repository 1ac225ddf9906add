"""`rs weights` — loss class weights from the training-label distribution.

This package's copy of robosat_tpu/tools/weights.py: the same code over the port's
own modules, held to the original by tests/test_torch_port_data_tools.py.

Contract parity: robosat/tools/weights.py — the ENet/LinkNet scheme
w = 1 / ln(1.02 + p) over the pixel class histogram of training/labels,
printed to stdout rounded to 6 decimals for pasting into the dataset TOML's
[weights] section.
"""

import argparse
import os

import numpy as np
from PIL import Image
from tqdm import tqdm

from robosat_tpu_torch.config import load_config
from robosat_tpu_torch.tiles import tiles_from_slippy_map


def add_parser(subparser):
    parser = subparser.add_parser(
        "weights",
        help="derives loss class weights from the training labels",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )

    parser.add_argument("--dataset", type=str, required=True, help="dataset TOML whose training labels are scanned")

    parser.set_defaults(func=main)


def class_histogram(labels_dir, num_classes):
    """Pixel counts per class over every label tile; returns (counts, total)."""
    counts = np.zeros(num_classes, dtype=np.int64)
    total = 0

    label_paths = [path for _, path in tiles_from_slippy_map(labels_dir)]
    for path in tqdm(label_paths, desc="Loading", unit="image", ascii=True):
        mask = np.array(Image.open(path).convert("P"), dtype=np.uint8)
        total += mask.size
        counts += np.bincount(mask.ravel(), minlength=num_classes)[:num_classes]

    return counts, total


def main(args):
    dataset = load_config(args.dataset)
    num_classes = len(dataset["common"]["classes"])
    labels_dir = os.path.join(dataset["common"]["dataset"], "training", "labels")

    counts, total = class_histogram(labels_dir, num_classes)
    assert total > 0, "dataset with masks must not be empty"

    # w = 1 / ln(1.02 + p): rare classes get large weights, bounded by the
    # 1.02 floor (arXiv:1606.02147 / arXiv:1707.03718).
    frequencies = counts / total
    weights = (1.0 / np.log(1.02 + frequencies)).round(6)

    print(weights.tolist())
