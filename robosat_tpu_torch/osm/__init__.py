"""OpenStreetMap extraction: the stdlib PBF and XML readers and the way handlers.

The port's own copies of robosat_tpu/osm/'s modules, which `extract` runs:
they stand in for the reference's pyosmium and import nothing of the JAX
package.
"""
