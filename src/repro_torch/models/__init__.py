"""The serving and training paths of all 10 architectures on torch:
configs, parameter specs, layers, the GQA, MLA, MoE and SSM blocks, the
model, its loss and the weight converter."""
from repro_torch.models.config import ModelConfig, Policy  # noqa: F401
from repro_torch.models.model import (  # noqa: F401
    cache_spec, cast_params, decode_step, forward, init_cache, init_model,
    loss_fn, model_spec, prefill,
)
