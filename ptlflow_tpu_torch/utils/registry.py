"""Model registry: decorator-based registration, as in
``ptlflow_tpu/utils/registry.py``."""

from __future__ import annotations

_models_dict = {}
_trainable_models = []
_ptlflow_trained_models = []


def register_model(model_class):
    _models_dict[model_class.__name__] = model_class
    return model_class


def trainable(model_class):
    _trainable_models.append(model_class.__name__)
    return model_class


def ptlflow_trained(model_class):
    _ptlflow_trained_models.append(model_class.__name__)
    return model_class
