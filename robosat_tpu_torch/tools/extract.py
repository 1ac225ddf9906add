"""`rs extract` — pull feature geometries out of an OpenStreetMap base map.

This package's copy of robosat_tpu/tools/extract.py: the same code over the port's
own modules, held to the original by tests/test_torch_port_osm.py.

Contract parity: robosat/tools/extract.py. The map streams through the
in-repo pure-Python PBF decoder (robosat_tpu_torch/osm/pbf.py) instead of
libosmium; plain .osm XML extracts work too.
"""

import argparse

from robosat_tpu_torch.osm.building import BuildingHandler
from robosat_tpu_torch.osm.parking import ParkingHandler
from robosat_tpu_torch.osm.road import RoadHandler

# A handler is an osmium-style `way(w)` callback plus `flush()`.
handlers = {
    "parking": ParkingHandler,
    "building": BuildingHandler,
    "road": RoadHandler,
}


def add_parser(subparser):
    parser = subparser.add_parser(
        "extract",
        help="turns OpenStreetMap features into GeoJSON",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )

    parser.add_argument("--type", type=str, required=True, choices=handlers.keys(), help="feature type to extract")
    parser.add_argument("--batch", type=int, default=100000, help="features per output file chunk")
    parser.add_argument("map", type=str, help=".osm.pbf (or .osm XML) base map to read")
    parser.add_argument("out", type=str, help="GeoJSON file path the chunks derive their names from")

    parser.set_defaults(func=main)


def main(args):
    handler = handlers[args.type](args.out, args.batch)
    handler.apply_file(filename=args.map, locations=True)
    handler.flush()
