"""Model families of the PyTorch port; importing registers them."""

from . import (ccmr, craft, csflow, dip, dpflow, flow1d,  # noqa: F401
               flowformer, flowformerplusplus, flowseek, gma, gmflownet, irr,
               lcv, llaflow, matchflow, memflow, memfof, ms_raft_plus,
               neuflow2, pwcnet, raft, rapidflow, recover, rpknet, scv,
               sea_raft, separableflow, skflow, splatflow, streamflow,
               videoflow, waft)
