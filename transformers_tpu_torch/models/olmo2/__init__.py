from .configuration_olmo2 import Olmo2Config
from .modeling_olmo2 import (
    Olmo2Attention,
    Olmo2DecoderLayer,
    Olmo2ForCausalLM,
    Olmo2Model,
    Olmo2ModelStandalone,
)
