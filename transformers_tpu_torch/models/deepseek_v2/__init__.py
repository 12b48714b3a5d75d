from .configuration_deepseek_v2 import DeepseekV2Config
from .modeling_deepseek_v2 import (
    DeepseekV2Attention,
    DeepseekV2DecoderLayer,
    DeepseekV2ForCausalLM,
    DeepseekV2Model,
    DeepseekV2ModelStandalone,
    DeepseekV2Moe,
    deepseek_v2_route,
)
