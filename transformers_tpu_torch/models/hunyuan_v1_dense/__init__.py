from .configuration_hunyuan_v1_dense import HunYuanDenseV1Config
from .modeling_hunyuan_v1_dense import (
    HunYuanDenseV1Attention,
    HunYuanDenseV1DecoderLayer,
    HunYuanDenseV1ForCausalLM,
    HunYuanDenseV1Model,
    HunYuanDenseV1ModelStandalone,
)
