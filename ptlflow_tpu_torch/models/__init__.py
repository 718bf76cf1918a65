"""Model families of the PyTorch port; importing registers them."""

from . import (ccmr, craft, csflow, dip, dpflow, fastflownet,  # noqa: F401
               flow1d, flowformer, flowformerplusplus, flownet, flowseek, gma,
               gmflownet, irr, lcv, liteflownet, llaflow, matchflow, memflow,
               memfof, ms_raft_plus, neuflow2, pwcnet, raft, rapidflow,
               recover, rpknet, scv, sea_raft, separableflow, skflow,
               splatflow, streamflow, videoflow, waft)
