"""Training: step builders and the loop."""

from repro_torch.train.loop import TrainConfig, train  # noqa: F401
from repro_torch.train.step import (  # noqa: F401
    init_train_state,
    make_eval_step,
    make_grad_fn,
    make_loss_fn,
    make_train_step,
    softmax_xent,
)
