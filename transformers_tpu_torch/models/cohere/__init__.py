from .configuration_cohere import CohereConfig
from .modeling_cohere import (CohereAttention, CohereDecoderLayer, CohereForCausalLM, CohereModel,
                              CohereModelStandalone)
