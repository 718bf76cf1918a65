from .rpknet import RPKNet, rpknet  # noqa: F401
