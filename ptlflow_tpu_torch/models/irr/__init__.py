from .irr import (  # noqa: F401
    IRRPWC, IRRPWCNet, IRRPWCNetIRR, ScopeFlow, irr_pwc, irr_pwcnet,
    irr_pwcnet_irr, scopeflow)
