from .scv import SCVEighth, SCVQuarter, scv4, scv8  # noqa: F401
