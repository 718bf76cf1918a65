from .flow1d import Flow1D, flow1d, lookup_1d  # noqa: F401
