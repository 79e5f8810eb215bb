"""Multi-process fitting and grid evaluation over torch.distributed, one
process per card (the JAX package's parallel/, in PyTorch's idiom)."""

from .mesh import Mesh, make_mesh
from .fit import fit_records_sharded, grid_eval_sharded

__all__ = ["Mesh", "make_mesh", "fit_records_sharded", "grid_eval_sharded"]
