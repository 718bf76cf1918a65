from .memfof import MEMFOF, memfof  # noqa: F401
