"""Parallelism of the port: the blocked large-P route (large_p.py), and
the dense and blocked routes over a single-controller device mesh
(mesh.py, collectives.py, reshard.py, sharded.py, large_p.py)."""

from pipelinedp_tpu_torch.parallel.mesh import Mesh, make_mesh

__all__ = ["Mesh", "make_mesh"]
