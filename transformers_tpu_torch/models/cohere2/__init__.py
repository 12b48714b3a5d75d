from .configuration_cohere2 import Cohere2Config
from .modeling_cohere2 import (
    Cohere2Attention,
    Cohere2DecoderLayer,
    Cohere2ForCausalLM,
    Cohere2Model,
    Cohere2ModelStandalone,
)
