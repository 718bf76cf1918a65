"""Model families of the PyTorch port; importing registers them."""

from . import (craft, dpflow, flowformer, flowformerplusplus,  # noqa: F401
               gma, lcv, memflow, neuflow2, raft, rapidflow, rpknet,
               sea_raft, skflow, streamflow, videoflow)
