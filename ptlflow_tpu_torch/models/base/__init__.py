from .base_model import BaseModel, bgr_val_as_tensor  # noqa: F401
