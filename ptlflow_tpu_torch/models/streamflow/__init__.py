from .streamflow import StreamFlow, streamflow  # noqa: F401
