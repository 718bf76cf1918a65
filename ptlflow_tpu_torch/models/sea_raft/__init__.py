from .sea_raft import (SEARAFT, SEARAFT_L, SEARAFT_M,  # noqa: F401
                       SEARAFT_S, sea_raft, sea_raft_l, sea_raft_m,
                       sea_raft_s)
