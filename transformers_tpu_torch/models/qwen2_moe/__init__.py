from .configuration_qwen2_moe import Qwen2MoeConfig
from .modeling_qwen2_moe import (
    Qwen2MoeDecoderLayer,
    Qwen2MoeForCausalLM,
    Qwen2MoeMLP,
    Qwen2MoeModel,
    Qwen2MoeSparseMoeBlock,
)
