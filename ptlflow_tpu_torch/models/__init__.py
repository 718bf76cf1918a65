"""Model families of the PyTorch port; importing registers them."""

from . import raft  # noqa: F401
