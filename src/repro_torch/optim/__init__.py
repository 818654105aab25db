from repro_torch.optim.optimizers import (OptState, adam_init, adam_update,
                                          clip_by_global_norm,
                                          cosine_schedule, make_optimizer,
                                          sgd_init, sgd_update, sgd_update_)

__all__ = ["OptState", "adam_init", "adam_update", "clip_by_global_norm",
           "cosine_schedule", "make_optimizer", "sgd_init", "sgd_update",
           "sgd_update_"]
