from .rapidflow import (  # noqa: F401
    RAPIDFlow, rapidflow, rapidflow_it1, rapidflow_it2, rapidflow_it3,
    rapidflow_it6)
