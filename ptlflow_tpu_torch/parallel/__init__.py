"""Training of the PyTorch port: the optimizer, its schedule and the train
step of ``ptlflow_tpu/parallel/train.py``, on one device."""

from .train import (AdamW, AdamWState, TrainState,  # noqa: F401
                    build_train_step, create_train_state, global_norm,
                    load_optimizer_state, loss_and_grads, make_optimizer,
                    onecycle_linear, optimizer_state_dict)
