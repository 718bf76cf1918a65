from .gma import GMA, gma  # noqa: F401
