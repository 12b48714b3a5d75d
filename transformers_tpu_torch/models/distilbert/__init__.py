from .configuration_distilbert import DistilBertConfig
from .modeling_distilbert import (
    DistilBertForMaskedLM,
    DistilBertForQuestionAnswering,
    DistilBertForSequenceClassification,
    DistilBertModel,
    DistilBertModelStandalone,
)
