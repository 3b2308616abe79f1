"""Training and serving steps: optimizers, the train step, serve steps."""
from .optimizer import (  # noqa: F401
    Optimizer, adafactor, adamw, cosine_schedule, make_optimizer)
from .serve_step import make_decode_step, make_prefill_step  # noqa: F401
from .train_step import TrainState, make_train_step  # noqa: F401
