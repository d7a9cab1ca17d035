from .adam import (OptConfig, apply_updates, global_grad_norm,  # noqa: F401
                   init_opt_state, merge_trainable, trainable_leaves)
