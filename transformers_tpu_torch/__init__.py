"""transformers_tpu_torch: the PyTorch/CUDA port of ``transformers_tpu``.

It imports ``torch`` and never ``jax`` or ``transformers_tpu``. Entry points
run on the CUDA card unless ``device="cpu"`` is passed. Kernels are built
from ``csrc/`` at first use (ops/cuda_build.py).
"""

from .configuration_utils import PretrainedConfig
from .convert import params_from_jax
from .generation import GenerationConfig
from .modeling_utils import PreTrainedModel
from .modeling_layers import (GenericForQuestionAnswering, GenericForSequenceClassification,
                              GenericForTokenClassification, last_token_indices)
from .models.auto import (AutoConfig, AutoModel, AutoModelForCausalLM, AutoModelForMaskedLM,
                          AutoModelForQuestionAnswering, AutoModelForSequenceClassification,
                          AutoModelForTokenClassification)
from .models.bert import (BertConfig, BertForMaskedLM, BertForQuestionAnswering,
                          BertForSequenceClassification, BertForTokenClassification,
                          BertModelStandalone)
from .models.cohere import CohereConfig, CohereForCausalLM, CohereModelStandalone
from .models.cohere2 import Cohere2Config, Cohere2ForCausalLM, Cohere2ModelStandalone
from .models.cohere2_moe import Cohere2MoeConfig, Cohere2MoeForCausalLM, Cohere2MoeModelStandalone
from .models.deepseek_v2 import DeepseekV2Config, DeepseekV2ForCausalLM, DeepseekV2ModelStandalone
from .models.deepseek_v3 import (DeepseekV3Config, DeepseekV3ForCausalLM,
                                 DeepseekV3ModelStandalone)
from .models.distilbert import (DistilBertConfig, DistilBertForMaskedLM,
                                DistilBertForQuestionAnswering,
                                DistilBertForSequenceClassification, DistilBertModelStandalone)
from .models.dots1 import Dots1Config, Dots1ForCausalLM, Dots1ModelStandalone
from .models.ernie4_5 import Ernie4_5Config, Ernie4_5ForCausalLM, Ernie4_5ModelStandalone
from .models.ernie4_5_moe import (Ernie4_5_MoeConfig, Ernie4_5_MoeForCausalLM,
                                  Ernie4_5_MoeModelStandalone)
from .models.gemma import GemmaConfig, GemmaForCausalLM, GemmaModelStandalone
from .models.gemma2 import Gemma2Config, Gemma2ForCausalLM, Gemma2ModelStandalone
from .models.gemma3 import Gemma3ForCausalLM, Gemma3TextConfig, Gemma3TextModelStandalone
from .models.glm4_moe import Glm4MoeConfig, Glm4MoeForCausalLM, Glm4MoeModelStandalone
from .models.gpt_oss import GptOssConfig, GptOssForCausalLM, GptOssModelStandalone
from .models.hunyuan_v1_dense import (HunYuanDenseV1Config, HunYuanDenseV1ForCausalLM,
                                      HunYuanDenseV1ModelStandalone)
from .models.hunyuan_v1_moe import (HunYuanMoEV1Config, HunYuanMoEV1ForCausalLM,
                                    HunYuanMoEV1ModelStandalone)
from .models.laguna import LagunaConfig, LagunaForCausalLM, LagunaModelStandalone
from .models.llama import (LlamaConfig, LlamaForCausalLM, LlamaForQuestionAnswering,
                           LlamaForSequenceClassification, LlamaForTokenClassification,
                           LlamaModelStandalone)
from .models.minimax_m2 import MiniMaxM2Config, MiniMaxM2ForCausalLM, MiniMaxM2ModelStandalone
from .models.mistral import (MistralConfig, MistralForCausalLM, MistralForQuestionAnswering,
                             MistralForSequenceClassification, MistralForTokenClassification,
                             MistralModelStandalone)
from .models.mistral4 import Mistral4Config, Mistral4ForCausalLM, Mistral4ModelStandalone
from .models.mixtral import MixtralConfig, MixtralForCausalLM, MixtralModelStandalone
from .models.modernbert import (ModernBertConfig, ModernBertForMaskedLM,
                                ModernBertForSequenceClassification,
                                ModernBertForTokenClassification, ModernBertModelStandalone)
from .models.olmo2 import Olmo2Config, Olmo2ForCausalLM, Olmo2ModelStandalone
from .models.olmoe import OlmoeConfig, OlmoeForCausalLM, OlmoeModelStandalone
from .models.phi3 import Phi3Config, Phi3ForCausalLM, Phi3ModelStandalone
from .models.phimoe import PhimoeConfig, PhimoeForCausalLM, PhimoeModelStandalone
from .models.qwen2 import (Qwen2Config, Qwen2ForCausalLM, Qwen2ForQuestionAnswering,
                           Qwen2ForSequenceClassification, Qwen2ForTokenClassification,
                           Qwen2ModelStandalone)
from .models.qwen2_moe import Qwen2MoeConfig, Qwen2MoeForCausalLM, Qwen2MoeModelStandalone
from .models.qwen3 import Qwen3Config, Qwen3ForCausalLM, Qwen3ModelStandalone
from .models.qwen3_moe import Qwen3MoeConfig, Qwen3MoeForCausalLM, Qwen3MoeModelStandalone
from .models.roberta import (RobertaConfig, RobertaForMaskedLM, RobertaForQuestionAnswering,
                             RobertaForSequenceClassification, RobertaForTokenClassification,
                             RobertaModelStandalone)
from .models.solar_open import SolarOpenConfig, SolarOpenForCausalLM, SolarOpenModelStandalone
from .models.xlm_roberta import (XLMRobertaConfig, XLMRobertaForMaskedLM,
                                 XLMRobertaModelStandalone)
from .pipelines import pipeline
from .quantizers import (Fp8WeightOnlyConfig, Int4WeightOnlyConfig, Int8WeightOnlyConfig,
                         QuantizationConfig, quantize_params)
from .tokenization import AutoTokenizer, BatchEncoding, PreTrainedTokenizer
from .trainer import Trainer
from .trainer_callback import TrainerCallback
from .training_args import TrainingArguments
