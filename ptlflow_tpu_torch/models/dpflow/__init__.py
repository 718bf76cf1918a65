from .dpflow import DPFlow, dpflow  # noqa: F401
