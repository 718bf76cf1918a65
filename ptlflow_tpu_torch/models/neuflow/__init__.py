from .neuflow import NeuFlow, neuflow  # noqa: F401
