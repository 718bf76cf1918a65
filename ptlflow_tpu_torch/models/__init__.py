"""Model families of the PyTorch port; importing registers them."""

from . import (flowformer, flowformerplusplus, gma, lcv,  # noqa: F401
               memflow, raft, sea_raft, skflow)
