"""Model families of the PyTorch port; importing registers them."""

from . import (craft, csflow, dip, dpflow, flow1d,  # noqa: F401
               flowformer, flowformerplusplus, flowseek, gma, gmflownet, lcv,
               llaflow, memflow, memfof, neuflow2, raft, rapidflow, recover,
               rpknet, sea_raft, skflow, splatflow, streamflow, videoflow,
               waft)
