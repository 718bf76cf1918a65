from .neuflow2 import NeuFlow2, neuflow2  # noqa: F401
