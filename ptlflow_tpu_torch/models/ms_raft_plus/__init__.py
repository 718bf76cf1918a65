from .ms_raft_plus import MSRAFTPlus, ms_raft_p  # noqa: F401
