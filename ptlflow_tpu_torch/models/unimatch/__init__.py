from .unimatch import (  # noqa: F401
    UniMatch, UniMatchScale2, UniMatchScale2With6Refinements, gmflow_p,
    gmflow_p_sc2, gmflow_p_sc2_ref6, unimatch, unimatch_sc2,
    unimatch_sc2_ref6)
