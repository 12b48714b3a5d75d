from .configuration_phi3 import Phi3Config
from .modeling_phi3 import (
    Phi3Attention,
    Phi3DecoderLayer,
    Phi3ForCausalLM,
    Phi3MLP,
    Phi3Model,
)
