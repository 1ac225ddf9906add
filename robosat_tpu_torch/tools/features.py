"""`rs features` — vectorize masks into GeoJSON features.

Counterpart of robosat_tpu/tools/features.py, with the same flags, messages
and chunking. The denoise+grow morphology runs as one batch over chunks of
tiles on the card (`main`'s `device`, the card when None; tests pass the
CPU), contour tracing and GeoJSON assembly stay on the host.
Contract parity: robosat/tools/features.py.
"""

import argparse
import sys

import numpy as np
import torch
from PIL import Image
from tqdm import tqdm

from robosat_tpu_torch.config import load_config
from robosat_tpu_torch.device import configure_device
from robosat_tpu_torch.features.building import BuildingHandler
from robosat_tpu_torch.features.parking import ParkingHandler
from robosat_tpu_torch.native import imagecodec
from robosat_tpu_torch.ops.morphology import denoise_grow
from robosat_tpu_torch.tiles import tiles_from_slippy_map

handlers = {"parking": ParkingHandler, "building": BuildingHandler}


def add_parser(subparser):
    parser = subparser.add_parser(
        "features",
        help="extracts simplified GeoJSON features from segmentation masks",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--type", type=str, required=True, choices=handlers.keys(), help="type of feature to extract")
    parser.add_argument("masks", type=str, help="slippy map directory to read masks from")
    parser.add_argument("out", type=str, help="path to GeoJSON file to store features in")
    parser.add_argument("--dataset", type=str, required=True, help="path to dataset configuration file")
    parser.add_argument("--chunk", type=int, default=16, help="tiles per batched morphology call")

    parser.set_defaults(func=main)


def _load_indices(path):
    """Mask tile as its palette-index array (native codec, PIL fallback)."""
    idx = imagecodec.decode_indices(path)
    if idx is None:
        idx = np.array(Image.open(path).convert("P"), dtype=np.uint8)
    return idx


def main(args, device=None):
    """Run the tool; `device` is where the morphology runs, the card when
    None (raising without one)."""
    if device is None:
        device = configure_device(True)
    dataset = load_config(args.dataset)

    labels = dataset["common"]["classes"]
    if args.type not in labels:
        sys.exit("Error: dataset classes do not contain type '{}'".format(args.type))
    index = labels.index(args.type)

    handler = handlers[args.type](device)

    tiles = list(tiles_from_slippy_map(args.masks))
    if not tiles:
        sys.exit("Error: no tiles found in {}".format(args.masks))

    progress = tqdm(total=len(tiles), ascii=True, unit="mask")
    for start in range(0, len(tiles), args.chunk):
        chunk = tiles[start : start + args.chunk]
        masks = np.stack(
            [(_load_indices(path) == index).astype(np.uint8) for _, path in chunk]
        )
        if len(chunk) < args.chunk:
            # Pad to the chunk's batch shape; padded rows are discarded below.
            masks = np.concatenate([masks, np.zeros((args.chunk - len(chunk),) + masks.shape[1:], np.uint8)])
        morphed = denoise_grow(
            torch.from_numpy(masks).to(device), handler.kernel_size_denoise, handler.kernel_size_grow
        ).cpu().numpy()
        for (tile, _), grown in zip(chunk, morphed):
            if tile.z != 18:
                raise NotImplementedError("Parking lot post-processing thresholds are tuned for z18")
            handler.apply_morphed(tile, grown)
        progress.update(len(chunk))
    progress.close()

    handler.save(args.out)
