from .fastflownet import FastFlowNet, fastflownet  # noqa: F401
