from .configuration_glm4_moe import Glm4MoeConfig
from .modeling_glm4_moe import (
    Glm4MoeAttention,
    Glm4MoeDecoderLayer,
    Glm4MoeForCausalLM,
    Glm4MoeModel,
    Glm4MoeModelStandalone,
)
