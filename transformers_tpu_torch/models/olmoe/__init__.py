from .configuration_olmoe import OlmoeConfig
from .modeling_olmoe import (
    OlmoeAttention,
    OlmoeDecoderLayer,
    OlmoeForCausalLM,
    OlmoeModel,
    OlmoeModelStandalone,
    OlmoeSparseMoeBlock,
)
