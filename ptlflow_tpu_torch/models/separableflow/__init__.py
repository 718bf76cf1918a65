from .separableflow import SeparableFlow, separableflow  # noqa: F401
