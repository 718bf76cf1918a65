from .hd3 import HD3, HD3Context, hd3, hd3_ctxt  # noqa: F401
