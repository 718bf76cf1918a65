from .splatflow import SplatFlow, splatflow  # noqa: F401
