from .skflow import SKFlow, skflow  # noqa: F401
