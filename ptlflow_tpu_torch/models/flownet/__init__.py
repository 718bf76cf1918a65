from .flownet import (  # noqa: F401
    FlowNet2, FlowNetC, FlowNetCS, FlowNetCSS, FlowNetFusion, FlowNetS,
    FlowNetSD, flownet2, flownetc, flownetcs, flownetcss, flownets,
    flownetsd)
