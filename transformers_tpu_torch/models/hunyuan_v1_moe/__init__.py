from .configuration_hunyuan_v1_moe import HunYuanMoEV1Config
from .modeling_hunyuan_v1_moe import (
    HunYuanMoEV1DecoderLayer,
    HunYuanMoEV1ForCausalLM,
    HunYuanMoEV1Model,
    HunYuanMoEV1ModelStandalone,
    HunYuanMoEV1Moe,
)
