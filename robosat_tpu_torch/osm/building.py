"""Building extraction from OSM ways.

This package's copy of robosat_tpu/osm/building.py: the same code over the port's
own modules, held to the original by tests/test_torch_port_osm.py.

Contract parity: robosat/osm/building.py — keep building=* ways except
structure and location types not visible from above, emit validity-checked
polygons.
"""

from robosat_tpu_torch.osm.core import FeatureStorage, is_polygon, way_to_polygon_feature
from robosat_tpu_torch.osm.pbf import SimpleHandler

# building=* values hidden from aerial imagery (robosat/osm/building.py:15-17).
INVISIBLE_BUILDINGS = frozenset(
    {"construction", "houseboat", "static_caravan", "stadium", "conservatory", "digester", "greenhouse", "ruins"}
)

# location=* values hidden from aerial imagery (robosat/osm/building.py:20).
INVISIBLE_LOCATIONS = frozenset({"underground", "underwater"})


def wanted(tags):
    """Tag predicate: is this way a building visible from above?"""
    building = tags.get("building")
    if building is None or building in INVISIBLE_BUILDINGS:
        return False
    return tags.get("location") not in INVISIBLE_LOCATIONS


class BuildingHandler(SimpleHandler):
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
