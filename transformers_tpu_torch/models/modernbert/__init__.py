from .configuration_modernbert import ModernBertConfig
from .modeling_modernbert import (
    ModernBertForMaskedLM,
    ModernBertForSequenceClassification,
    ModernBertForTokenClassification,
    ModernBertModel,
    ModernBertModelStandalone,
)
