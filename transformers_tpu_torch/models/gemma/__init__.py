from .configuration_gemma import GemmaConfig
from .modeling_gemma import (
    GemmaAttention,
    GemmaDecoderLayer,
    GemmaForCausalLM,
    GemmaMLP,
    GemmaModel,
    GemmaModelStandalone,
)
