from .configuration_mixtral import MixtralConfig
from .modeling_mixtral import (
    MixtralDecoderLayer,
    MixtralForCausalLM,
    MixtralModel,
    MixtralSparseMoeBlock,
)
