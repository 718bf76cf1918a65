from .llaflow import (LLAFlow, LLAFlowRAFT, llaflow,  # noqa: F401
                      llaflow_raft)
