from .configuration_phimoe import PhimoeConfig
from .modeling_phimoe import (
    PhimoeDecoderLayer,
    PhimoeForCausalLM,
    PhimoeModel,
    PhimoeModelStandalone,
    PhimoeSparseMoeBlock,
    sparsemixer_route,
)
