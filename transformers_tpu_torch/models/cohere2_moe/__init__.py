from .configuration_cohere2_moe import Cohere2MoeConfig
from .modeling_cohere2_moe import (
    Cohere2MoeAttention,
    Cohere2MoeDecoderLayer,
    Cohere2MoeForCausalLM,
    Cohere2MoeModel,
    Cohere2MoeModelStandalone,
    Cohere2MoeSparseMoeBlock,
    cohere2_moe_route,
)
