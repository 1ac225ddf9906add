from robosat_tpu_torch.graph.core import UndirectedGraph  # noqa: F401
