from .configuration_minimax_m2 import MiniMaxM2Config
from .modeling_minimax_m2 import (
    MiniMaxM2DecoderLayer,
    MiniMaxM2ForCausalLM,
    MiniMaxM2Model,
    MiniMaxM2ModelStandalone,
    MiniMaxM2SparseMoeBlock,
)
