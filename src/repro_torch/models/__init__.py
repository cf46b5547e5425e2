"""The serving path of the dense decoders, mamba2 and zamba2 on torch:
configs, parameter specs, layers, the GQA and SSM blocks, the model and
the weight converter."""
from repro_torch.models.config import ModelConfig, Policy  # noqa: F401
from repro_torch.models.model import (  # noqa: F401
    cache_spec, cast_params, decode_step, forward, init_cache, init_model,
    model_spec, prefill,
)
