"""Model families of the PyTorch port; importing registers them."""

from . import (ccmr, craft, csflow, dip, dpflow, flow1d,  # noqa: F401
               flowformer, flowformerplusplus, flowseek, gma, gmflownet, lcv,
               llaflow, matchflow, memflow, memfof, ms_raft_plus, neuflow2,
               raft, rapidflow, recover, rpknet, scv, sea_raft, skflow,
               splatflow, streamflow, videoflow, waft)
