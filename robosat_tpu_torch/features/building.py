"""Building featurization: binary masks -> GeoJSON building polygons.

This package's copy of robosat_tpu/features/building.py: the same code over the port's
own modules, held to the original by tests/test_torch_port_vector_tools.py.

Capability extension beyond the reference (its features tool registers only
the parking handler, robosat/tools/features.py:16; buildings were a roadmap
item). Buildings are smaller and denser than parking lots, so the z18
morphology kernels are tighter and the simplification keeps corners sharper.
"""

from robosat_tpu_torch.features.parking import ParkingHandler


class BuildingHandler(ParkingHandler):
    kernel_size_denoise = 9
    kernel_size_grow = 9
    simplify_threshold = 0.005
