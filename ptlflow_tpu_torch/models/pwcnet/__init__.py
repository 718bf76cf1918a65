from .pwcnet import PWCDCNet, PWCNet, pwcnet, pwcnet_nodc  # noqa: F401
