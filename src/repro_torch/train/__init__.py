from .step import (STEP_TOL, TrainState, cross_entropy_loss,
                   grad_payload_stats, loss_and_grads, make_train_step,
                   step_deviation, train_state_init)

__all__ = ["STEP_TOL", "TrainState", "cross_entropy_loss",
           "grad_payload_stats", "loss_and_grads", "make_train_step",
           "step_deviation", "train_state_init"]
