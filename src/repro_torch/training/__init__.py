"""Serving engine and distillation training of the port."""
from repro_torch.training.serve import GenRequest, ServingEngine
from repro_torch.training.train_step import (TrainState, chunked_topk_kl,
                                             init_train_state, lm_loss,
                                             make_loss_fn, make_train_step)

__all__ = ["GenRequest", "ServingEngine", "TrainState", "chunked_topk_kl",
           "init_train_state", "lm_loss", "make_loss_fn", "make_train_step"]
