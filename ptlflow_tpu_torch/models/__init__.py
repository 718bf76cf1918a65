"""Model families of the PyTorch port; importing registers them."""

from . import flowformer, flowformerplusplus, gma, raft, sea_raft  # noqa: F401
