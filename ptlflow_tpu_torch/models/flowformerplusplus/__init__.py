from .flowformerplusplus import FlowFormerPlusPlus, flowformer_pp  # noqa: F401
