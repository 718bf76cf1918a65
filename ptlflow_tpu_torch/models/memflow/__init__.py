from .memflow import MemFlow, MemFlowT, memflow, memflow_t  # noqa: F401
