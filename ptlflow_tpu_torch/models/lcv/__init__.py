from .lcv_raft import (LCV_RAFT, LCV_RAFTSmall, lcv_raft,  # noqa: F401
                       lcv_raft_small)
