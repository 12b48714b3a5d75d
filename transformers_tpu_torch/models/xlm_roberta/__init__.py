from .modeling_xlm_roberta import (XLMRobertaConfig, XLMRobertaForMaskedLM, XLMRobertaModel,
                                   XLMRobertaModelStandalone)
