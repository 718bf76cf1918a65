from .dip import DIP, PathMatch, dip, init_flow  # noqa: F401
