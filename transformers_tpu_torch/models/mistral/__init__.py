from .configuration_mistral import MistralConfig
from .modeling_mistral import (
    MistralAttention,
    MistralDecoderLayer,
    MistralForCausalLM,
    MistralForQuestionAnswering,
    MistralForSequenceClassification,
    MistralForTokenClassification,
    MistralMLP,
    MistralModel,
    MistralModelStandalone,
)
