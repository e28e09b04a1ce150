"""Launch layer: serving and training drivers, and the distribution
layer: production meshes over DeviceMesh, sharding rules as DTensor
placements, input shapes, and the dry run (`python -m
repro_torch.launch.dryrun`), which traces a step on a fake 256/512-rank
mesh."""
from . import hlo_analysis, mesh, shapes, sharding  # noqa: F401
from .mesh import data_axes, make_local_mesh, make_production_mesh
from .shapes import SHAPES, InputShape, applicability, input_specs

__all__ = ["hlo_analysis", "mesh", "shapes", "sharding", "data_axes",
           "make_local_mesh", "make_production_mesh", "SHAPES", "InputShape",
           "applicability", "input_specs"]
