"""GeoJSON reading/writing helpers (stdlib json based).

This package's copy of robosat_tpu/geo/geojson.py: the same code over the port's
own modules, held to the original by tests/test_torch_port_geo.py.

Replaces the `geojson` package used across the reference for feature I/O
(robosat/osm/core.py, robosat/tools/{merge,dedupe,features}.py). Features and
collections are plain dicts in the GeoJSON structure.
"""

import json


def feature(geometry, properties=None):
    """A GeoJSON Feature dict from a geometry mapping or Geometry object."""
    if hasattr(geometry, "__geo_interface__"):
        geometry = geometry.__geo_interface__()
    return {"type": "Feature", "geometry": geometry, "properties": properties or {}}


def feature_collection(features):
    return {"type": "FeatureCollection", "features": list(features)}


def polygon_geometry(rings):
    """A GeoJSON Polygon mapping from coordinate rings (closed or not)."""
    out = []
    for ring in rings:
        ring = [list(map(float, pt)) for pt in ring]
        if ring and ring[0] != ring[-1]:
            ring.append(ring[0])
        out.append(ring)
    return {"type": "Polygon", "coordinates": out}


def linestring_geometry(coords):
    return {"type": "LineString", "coordinates": [list(map(float, pt)) for pt in coords]}


def load(fp):
    return json.load(fp)


def loads(s):
    return json.loads(s)


def dump(obj, fp):
    # json.dump streams through the pure-Python iterencode path
    # (_one_shot=False); dumps takes the C-accelerated encoder — ~5x on
    # coordinate-heavy collections for one extra in-memory copy.
    fp.write(json.dumps(obj))


def dumps(obj):
    return json.dumps(obj)
