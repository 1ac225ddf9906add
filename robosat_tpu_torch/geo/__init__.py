"""Host-side geospatial core: tile bounds, projections, geometry, indexing.

The port's own copies of the modules of robosat_tpu/geo/ that the vector
tools (`features`, `merge`, `dedupe`) run: they stand in for the reference's
mercantile, pyproj, shapely and rtree, and import nothing of the JAX package.
"""
