from .configuration_gemma3 import Gemma3TextConfig
from .modeling_gemma3 import (
    Gemma3Attention,
    Gemma3DecoderLayer,
    Gemma3ForCausalLM,
    Gemma3TextModel,
    Gemma3TextModelStandalone,
)
