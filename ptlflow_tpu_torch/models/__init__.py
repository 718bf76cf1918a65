"""Model families of the PyTorch port; importing registers them."""

from . import (craft, csflow, dpflow, flowformer,  # noqa: F401
               flowformerplusplus, gma, lcv, llaflow, memflow, memfof,
               neuflow2, raft, rapidflow, recover, rpknet, sea_raft, skflow,
               splatflow, streamflow, videoflow)
