from .configuration_laguna import LagunaConfig
from .modeling_laguna import (
    LagunaAttention,
    LagunaDecoderLayer,
    LagunaForCausalLM,
    LagunaModel,
    LagunaModelStandalone,
    LagunaSparseMoeBlock,
    LagunaTopKRouter,
)
