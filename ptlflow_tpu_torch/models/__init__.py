"""Model families of the PyTorch port; importing registers them."""

from . import gma, raft, sea_raft  # noqa: F401
