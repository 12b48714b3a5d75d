from .configuration_phimoe import PhimoeConfig
from .modeling_phimoe import (
    PhimoeDecoderLayer,
    PhimoeForCausalLM,
    PhimoeModel,
    PhimoeSparseMoeBlock,
    sparsemixer_route,
)
