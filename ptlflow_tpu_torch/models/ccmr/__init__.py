from .ccmr import CCMR, CCMRPlus, ccmr, ccmr_p  # noqa: F401
