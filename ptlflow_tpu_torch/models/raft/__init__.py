from .raft import RAFT, RAFTSmall, raft, raft_small  # noqa: F401
