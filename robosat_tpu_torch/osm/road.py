"""Road extraction from OSM ways: centerlines widened into polygons.

This package's copy of robosat_tpu/osm/road.py: the same code over the port's
own modules, held to the original by tests/test_torch_port_osm.py.

Contract parity: robosat/osm/road.py — per-highway-class width model (lanes,
lane width, shoulders), doubled lanes unless oneway, `lanes`/`width` tag
overrides with guards, centerline buffered by half the width converted to
degrees on the mean-radius sphere.
"""

import math
import sys

from robosat_tpu_torch.geo import geojson
from robosat_tpu_torch.geo.buffer import buffer_geometry
from robosat_tpu_torch.geo.geometry import LineString, mapping
from robosat_tpu_torch.osm.core import FeatureStorage
from robosat_tpu_torch.osm.pbf import SimpleHandler


class RoadHandler(SimpleHandler):
    # (lanes, lane width m, left hard-shoulder m, right hard-shoulder m)
    highway_attributes = {
        "motorway": (4, 3.75, 0.75, 3.00),
        "trunk": (3, 3.75, 0.75, 3.00),
        "primary": (2, 3.75, 0.50, 1.50),
        "secondary": (1, 3.50, 0.00, 0.75),
        "tertiary": (1, 3.50, 0.00, 0.75),
        "unclassified": (1, 3.50, 0.00, 0.00),
        "residential": (1, 3.50, 0.00, 0.75),
        "service": (1, 3.00, 0.00, 0.00),
        "motorway_link": (2, 3.75, 0.75, 3.00),
        "trunk_link": (2, 3.75, 0.50, 1.50),
        "primary_link": (1, 3.50, 0.00, 0.75),
        "secondary_link": (1, 3.50, 0.00, 0.75),
        "tertiary_link": (1, 3.50, 0.00, 0.00),
    }

    EARTH_MEAN_RADIUS = 6371004.0

    def __init__(self, out, batch):
        super().__init__()
        self.storage = FeatureStorage(out, batch)

    def way(self, w):
        highway = w.tags.get("highway")
        if highway not in self.highway_attributes:
            return

        lanes, lane_width, left_shoulder, right_shoulder = self.highway_attributes[highway]

        # Two directions of traffic unless tagged one-way.
        if w.tags.get("oneway", "no") == "no":
            lanes = lanes * 2

        if "lanes" in w.tags:
            try:
                lanes = max(int(w.tags["lanes"]), 1)
            except ValueError:
                print("Warning: invalid feature: https://www.openstreetmap.org/way/{}".format(w.id), file=sys.stderr)

        road_width = left_shoulder + lane_width * lanes + right_shoulder

        if "width" in w.tags:
            try:
                road_width = max(float(w.tags["width"]), 1.0)
            except ValueError:
                print("Warning: invalid feature: https://www.openstreetmap.org/way/{}".format(w.id), file=sys.stderr)

        coords = [(n.lon, n.lat) for n in w.nodes]
        if len(coords) < 2:
            print("Warning: invalid feature: https://www.openstreetmap.org/way/{}".format(w.id), file=sys.stderr)
            return

        line = LineString(coords)
        radius_deg = math.degrees(road_width / 2.0 / self.EARTH_MEAN_RADIUS)
        buffered = buffer_geometry(line, radius_deg)
        self.storage.add(geojson.feature(mapping(buffered)))

    def flush(self):
        self.storage.flush()
