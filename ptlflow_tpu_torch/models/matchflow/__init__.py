from .matchflow import (MatchFlow, MatchFlowRAFT, matchflow,  # noqa: F401
                        matchflow_raft)
