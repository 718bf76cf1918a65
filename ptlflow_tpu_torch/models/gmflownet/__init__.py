from .gmflownet import (GMFlowNet, GMFlowNetMix, gmflownet,  # noqa: F401
                        gmflownet_mix)
