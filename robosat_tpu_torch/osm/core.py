"""Shared OSM extraction plumbing: chunked feature output, way predicates.

This package's copy of robosat_tpu/osm/core.py: the same code over the port's
own modules, held to the original by tests/test_torch_port_osm.py.

Contract parity: robosat/osm/core.py (uniquely-suffixed `out-<hex>.geojson`
chunks; a polygon way is closed with >= 4 nodes counting the repeat).
"""

import os
import uuid

from robosat_tpu_torch.geo import geojson


class FeatureStorage:
    """Accumulates GeoJSON features, spilling every `batch` to its own file.

    The final partial batch only reaches disk via an explicit `flush()`.
    """

    def __init__(self, out, batch):
        assert batch > 0
        self.out = out
        self.batch = batch
        self.features = []

    def add(self, feature):
        if len(self.features) >= self.batch:
            self.flush()
        self.features.append(feature)

    def flush(self):
        if not self.features:
            return

        stem, suffix = os.path.splitext(self.out)
        chunk_path = "{}-{}{}".format(stem, uuid.uuid4().hex, suffix)
        with open(chunk_path, "w") as fp:
            geojson.dump(geojson.feature_collection(self.features), fp)

        self.features.clear()


def is_polygon(way):
    """A way can close into a polygon ring: closed, >= 4 nodes including the
    repeated endpoint. (Geometric validity is checked separately.)"""
    return way.is_closed() and len(way.nodes) >= 4


def way_to_polygon_feature(way):
    """Build a validity-checked GeoJSON polygon feature from a closed way.

    Returns None (warning on stderr, robosat/osm/parking.py:39 behavior) when
    the ring is geometrically invalid — self-intersecting, zero-area, etc.
    """
    import sys

    from robosat_tpu_torch.geo.geometry import shape

    geometry = geojson.polygon_geometry([[(n.lon, n.lat) for n in way.nodes]])
    if not shape(geometry).is_valid:
        print("Warning: invalid feature: https://www.openstreetmap.org/way/{}".format(way.id), file=sys.stderr)
        return None
    return geojson.feature(geometry)
