"""Parking-lot featurization: binary masks -> GeoJSON polygons with holes.

This package's copy of robosat_tpu/features/parking.py: the same code over the port's
own modules, held to the original by tests/test_torch_port_vector_tools.py.

Contract parity: robosat/features/parking.py (z18-tuned kernel sizes and
simplification threshold, ring-hierarchy reconstruction, validity filtering).
The morphology half can run pre-batched on the device via `apply_morphed`;
the plain `apply` keeps the reference's per-tile entry point and runs the
morphology on the handler's `device`.
"""

import collections
import sys

from robosat_tpu_torch.features.core import contours, denoise, featurize, grow, parents_in_hierarchy, simplify
from robosat_tpu_torch.geo import geojson
from robosat_tpu_torch.geo.geometry import shape


class ParkingHandler:
    kernel_size_denoise = 20
    kernel_size_grow = 20
    simplify_threshold = 0.01

    def __init__(self, device):
        self.features = []
        self.device = device

    def apply(self, tile, mask):
        """Vectorize one tile's binary mask (morphology on `device`, per tile)."""
        if tile.z != 18:
            raise NotImplementedError("Parking lot post-processing thresholds are tuned for z18")

        denoised = denoise(mask, self.kernel_size_denoise, self.device)
        grown = grow(denoised, self.kernel_size_grow, self.device)
        self.apply_morphed(tile, grown)

    def apply_morphed(self, tile, grown):
        """Vectorize a mask that already went through denoise+grow (the
        batched device path used by `rs features`)."""
        multipolygons, hierarchy = contours(grown)

        if hierarchy is None:
            return
        assert len(hierarchy) == 1, "always single hierarchy for all polygons in multipolygon"
        hierarchy = hierarchy[0]
        assert len(multipolygons) == len(hierarchy), "polygons and hierarchy in sync"

        polygons = [simplify(polygon, self.simplify_threshold) for polygon in multipolygons]

        # Group rings by their root ancestor: root id -> {root and its inner
        # ring ids}. Deeper nestings (islands inside holes) are skipped, like
        # the reference (robosat/features/parking.py:64-75).
        grouped = collections.defaultdict(set)

        for i, polygon in enumerate(polygons):
            if len(polygon) < 3:
                print("Warning: simplified feature no longer valid polygon, skipping", file=sys.stderr)
                continue

            ancestors = list(parents_in_hierarchy(i, hierarchy))
            if len(ancestors) > 1:
                print("Warning: polygon ring nesting level too deep, skipping", file=sys.stderr)
                continue

            root = ancestors[-1] if ancestors else i
            grouped[root].add(i)

        for outer, members in grouped.items():
            rings = [featurize(tile, polygons[outer], grown.shape[:2])]
            for child in members - {outer}:
                rings.append(featurize(tile, polygons[child], grown.shape[:2]))

            geometry = geojson.polygon_geometry(rings)
            if shape(geometry).is_valid:
                self.features.append(geojson.feature(geometry))
            else:
                print("Warning: extracted feature is not valid, skipping", file=sys.stderr)

    def save(self, out):
        collection = geojson.feature_collection(self.features)
        with open(out, "w") as fp:
            geojson.dump(collection, fp)
