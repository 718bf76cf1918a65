from .flowformer import FlowFormer, flowformer  # noqa: F401
