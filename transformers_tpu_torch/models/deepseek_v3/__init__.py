from .configuration_deepseek_v3 import DeepseekV3Config
from .modeling_deepseek_v3 import (
    DeepseekV3Attention,
    DeepseekV3DecoderLayer,
    DeepseekV3ForCausalLM,
    DeepseekV3Model,
    DeepseekV3MoE,
    DeepseekV3TopkRouter,
    deepseek_route,
)
