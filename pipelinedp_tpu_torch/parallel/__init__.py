"""Parallelism of the port: the blocked large-P route for one device
(large_p.py), and the dense route over a single-controller device mesh
(mesh.py, collectives.py, reshard.py, sharded.py)."""

from pipelinedp_tpu_torch.parallel.mesh import Mesh, make_mesh

__all__ = ["Mesh", "make_mesh"]
