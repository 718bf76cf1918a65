from .gmflow import GMFlow, GMFlowWithRefinement, gmflow, gmflow_refine  # noqa: F401
