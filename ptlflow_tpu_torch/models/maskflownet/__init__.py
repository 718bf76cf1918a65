from .maskflownet import (  # noqa: F401
    MaskFlownet, MaskFlownet_S, maskflownet, maskflownet_s)
