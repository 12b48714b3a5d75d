from .configuration_mistral4 import Mistral4Config
from .modeling_mistral4 import (
    Mistral4Attention,
    Mistral4DecoderLayer,
    Mistral4ForCausalLM,
    Mistral4MoE,
    Mistral4Model,
    Mistral4ModelStandalone,
    mistral4_route,
)
