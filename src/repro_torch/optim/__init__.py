"""The optimizer: AdamW with global-norm clipping and a cosine schedule,
and int8 gradient compression — the port of ``repro.optim``."""
from repro_torch.optim.adamw import (AdamWConfig, TrainState,  # noqa: F401
                                     apply_updates, global_norm, init_state,
                                     schedule)
