from .configuration_ernie4_5 import Ernie4_5Config
from .modeling_ernie4_5 import (
    Ernie4_5Attention,
    Ernie4_5DecoderLayer,
    Ernie4_5ForCausalLM,
    Ernie4_5MLP,
    Ernie4_5Model,
    Ernie4_5ModelStandalone,
)
