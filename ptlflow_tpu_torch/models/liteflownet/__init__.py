from .liteflownet import LiteFlowNet, liteflownet  # noqa: F401
from .liteflownet2 import (  # noqa: F401
    LiteFlowNet2, liteflownet2, liteflownet2_pseudoreg)
from .liteflownet3 import (  # noqa: F401
    LiteFlowNet3, liteflownet3, liteflownet3_pseudoreg, liteflownet3s,
    liteflownet3s_pseudoreg)
