from .dicl import DICL, dicl  # noqa: F401
