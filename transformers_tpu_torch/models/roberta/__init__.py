from .configuration_roberta import RobertaConfig
from .modeling_roberta import (
    RobertaForMaskedLM,
    RobertaForQuestionAnswering,
    RobertaForSequenceClassification,
    RobertaForTokenClassification,
    RobertaModel,
    RobertaModelStandalone,
)
