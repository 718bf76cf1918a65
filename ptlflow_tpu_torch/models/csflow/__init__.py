from .csflow import CSFlow, csflow  # noqa: F401
