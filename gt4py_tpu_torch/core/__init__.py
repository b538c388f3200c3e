from .definitions import Extent, Boundary  # noqa: F401
