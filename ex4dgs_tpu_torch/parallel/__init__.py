"""Multi-process parallelism: the (data, gauss) mesh of ranks, its
collectives, and the sharded train step."""

from .mesh import Mesh, make_mesh  # noqa: F401
