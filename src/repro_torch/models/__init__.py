from repro_torch.models.config import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import (
    ParamTree,
    abstract_params,
    decode_step,
    forward,
    init_cache,
    init_params,
    next_token_loss,
)

__all__ = [
    "INPUT_SHAPES",
    "InputShape",
    "ModelConfig",
    "ParamTree",
    "abstract_params",
    "decode_step",
    "forward",
    "init_cache",
    "init_params",
    "next_token_loss",
    "params_from_numpy",
]
