from .configuration_gpt_oss import GptOssConfig
from .modeling_gpt_oss import (
    GptOssAttention,
    GptOssDecoderLayer,
    GptOssExperts,
    GptOssForCausalLM,
    GptOssMLP,
    GptOssModel,
    GptOssModelStandalone,
    GptOssRouter,
)
