from .configuration_ernie4_5_moe import Ernie4_5_MoeConfig
from .modeling_ernie4_5_moe import (
    Ernie4_5_MoeDecoderLayer,
    Ernie4_5_MoeForCausalLM,
    Ernie4_5_MoeModel,
    Ernie4_5_MoeModelStandalone,
    Ernie4_5_MoeSparseMoeBlock,
)
