from .configuration_bert import BertConfig
from .modeling_bert import (
    BertForMaskedLM,
    BertForQuestionAnswering,
    BertForSequenceClassification,
    BertForTokenClassification,
    BertModel,
    BertModelStandalone,
)
