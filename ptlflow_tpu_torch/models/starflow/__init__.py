from .starflow import StarFlow, starflow  # noqa: F401
