"""Parking-lot extraction from OSM ways.

This package's copy of robosat_tpu/osm/parking.py: the same code over the port's
own modules, held to the original by tests/test_torch_port_osm.py.

Contract parity: robosat/osm/parking.py — keep amenity=parking ways except
the parking=* types not visible from above, emit validity-checked polygons.
"""

from robosat_tpu_torch.osm.core import FeatureStorage, is_polygon, way_to_polygon_feature
from robosat_tpu_torch.osm.pbf import SimpleHandler

# parking=* values hidden from aerial imagery (robosat/osm/parking.py:15).
INVISIBLE_PARKING = frozenset({"underground", "sheds", "carports", "garage_boxes"})


def wanted(tags):
    """Tag predicate: is this way a parking lot visible from above?"""
    return tags.get("amenity") == "parking" and tags.get("parking") not in INVISIBLE_PARKING


class ParkingHandler(SimpleHandler):
    def __init__(self, out, batch):
        super().__init__()
        self.storage = FeatureStorage(out, batch)

    def way(self, w):
        if not (is_polygon(w) and wanted(w.tags)):
            return
        feature = way_to_polygon_feature(w)
        if feature is not None:
            self.storage.add(feature)

    def flush(self):
        self.storage.flush()
