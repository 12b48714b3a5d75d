from .configuration_gemma2 import Gemma2Config
from .modeling_gemma2 import (
    Gemma2Attention,
    Gemma2DecoderLayer,
    Gemma2ForCausalLM,
    Gemma2MLP,
    Gemma2Model,
    Gemma2ModelStandalone,
)
