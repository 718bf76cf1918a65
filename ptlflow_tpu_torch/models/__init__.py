"""Model families of the PyTorch port; importing registers them."""

from . import (dpflow, flowformer, flowformerplusplus, gma,  # noqa: F401
               lcv, memflow, raft, rapidflow, rpknet, sea_raft, skflow)
