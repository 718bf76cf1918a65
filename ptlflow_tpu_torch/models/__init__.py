"""Model families of the PyTorch port; importing registers them."""

from . import (ccmr, craft, csflow, dicl, dip, dpflow,  # noqa: F401
               fastflownet, flow1d, flowformer, flowformerplusplus, flownet,
               flowseek, gma, gmflow, gmflownet, hd3, irr, lcv, liteflownet,
               llaflow, maskflownet, matchflow, memflow, memfof,
               ms_raft_plus, neuflow, neuflow2, pwcnet, raft, rapidflow,
               recover, rpknet, scv, sea_raft, separableflow, skflow,
               splatflow, starflow, streamflow, vcn, videoflow, waft)
