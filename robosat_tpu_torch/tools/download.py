"""`rs download` — fetch imagery for a CSV tile list from a tile endpoint.

This package's copy of robosat_tpu/tools/download.py: the same code over the port's
own modules, held to the original by tests/test_torch_port_data_tools.py.
`requests` is imported by `main`, not with the module, so that the command
line and the other tools load where it is not installed; there `download`
fails with the ImportError.

Contract parity: robosat/tools/download.py — a thread pool whose size doubles
as the request rate limit, existing files skipped, images re-encoded through
PIL, failures reported and skipped.
"""

import argparse
import concurrent.futures as futures
import os
import sys
import time

from PIL import Image
from tqdm import tqdm

from robosat_tpu_torch.tiles import fetch_image, tiles_from_csv


def add_parser(subparser):
    parser = subparser.add_parser(
        "download", help="fetches tile imagery from a tile server", formatter_class=argparse.ArgumentDefaultsHelpFormatter
    )

    parser.add_argument("url", type=str, help="tile endpoint with {z}/{x}/{y} placeholders")
    parser.add_argument("--ext", type=str, default="webp", help="image format suffix for saved tiles")
    parser.add_argument("--rate", type=int, default=10, help="max requests per second")
    parser.add_argument("tiles", type=str, help="csv of tile ids to fetch")
    parser.add_argument("out", type=str, help="slippy map directory to store tiles in")

    parser.set_defaults(func=main)


def _fetch_one(session, args, tile, seconds_per_slot):
    started = time.monotonic()

    dst_dir = os.path.join(args.out, str(tile.z), str(tile.x))
    os.makedirs(dst_dir, exist_ok=True)
    dst = os.path.join(dst_dir, "{}.{}".format(tile.y, args.ext))

    if os.path.isfile(dst):
        return True

    res = fetch_image(session, args.url.format(x=tile.x, y=tile.y, z=tile.z))
    if not res:
        return False

    try:
        Image.open(res).save(dst, optimize=True)
    except OSError:
        return False

    # Each worker owns a 1/rate-per-worker time slot; sleeping out the
    # remainder keeps the pool's aggregate request rate at --rate.
    elapsed = time.monotonic() - started
    if elapsed < seconds_per_slot:
        time.sleep(seconds_per_slot - elapsed)
    return True


def main(args):
    import requests

    tiles = list(tiles_from_csv(args.tiles))
    workers = args.rate
    seconds_per_slot = workers / args.rate

    with requests.Session() as session, tqdm(total=len(tiles), ascii=True, unit="image") as progress:

        def worker(tile):
            ok = _fetch_one(session, args, tile, seconds_per_slot)
            progress.update()
            return tile, ok

        with futures.ThreadPoolExecutor(workers) as pool:
            for tile, ok in pool.map(worker, tiles):
                if not ok:
                    print("Warning: {} failed, skipping".format(tile), file=sys.stderr)
