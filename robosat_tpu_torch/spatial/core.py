"""Spatial utilities: projections on geometries, shape IoU, spatial index.

This package's copy of robosat_tpu/spatial/core.py: the same code over the port's
own modules, held to the original by tests/test_torch_port_geo.py.

Same API surface as the reference (robosat/spatial/core.py: project_*, union,
iou, make_index) built on the from-scratch geo stack instead of
pyproj/shapely/rtree.
"""

from robosat_tpu_torch.geo import clip, proj
from robosat_tpu_torch.geo.geometry import transform_geometry
from robosat_tpu_torch.geo.index import STRtree


def project_ea(shape):
    """WGS84 lon/lat -> world Mollweide (ESRI:54009), an equal-area CRS."""
    return transform_geometry(proj.wgs_to_mollweide, shape)


def project_wgs_el(shape):
    """WGS84 lon/lat -> EPSG:3395 world mercator meters."""
    return transform_geometry(proj.wgs_to_worldmercator, shape)


def project_el_wgs(shape):
    """EPSG:3395 world mercator meters -> WGS84 lon/lat."""
    return transform_geometry(proj.worldmercator_to_wgs, shape)


def union(shapes):
    """The union of all shapes as one geometry.

    Parity: robosat/spatial/core.py:25-40.
    """
    assert shapes
    return clip.union_all(list(shapes))


def iou(lhs, rhs):
    """Intersection-over-union of two shapes, measured in an equal-area
    projection. Parity: robosat/spatial/core.py:56-77."""
    lhs = project_ea(lhs)
    rhs = project_ea(rhs)

    # ONE overlay for both areas (the former union overlay doubled the
    # dedupe hot path's cost; computing union from shoelace areas instead
    # broke the snap-error cancellation between the two measures).
    inter, union_area = clip.overlay_iou_areas(lhs, rhs)
    if union_area == 0:
        return 0.0
    rv = inter / union_area
    assert -1e-9 <= rv <= 1 + 1e-9
    return min(max(rv, 0.0), 1.0)


def make_index(shapes):
    """Bulk-load a spatial index over the shapes' bounding boxes.

    Parity: robosat/spatial/core.py:80-100 (returns an object with an
    `intersection(bounds)` iterator of candidate indices).
    """
    return STRtree([shape.bounds for shape in shapes])
