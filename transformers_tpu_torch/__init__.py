"""transformers_tpu_torch: the PyTorch/CUDA port of ``transformers_tpu``.

It imports ``torch`` and never ``jax`` or ``transformers_tpu``. Entry points
run on the CUDA card unless ``device="cpu"`` is passed. Kernels are built
from ``csrc/`` at first use (ops/cuda_build.py).
"""

from .configuration_utils import PretrainedConfig
from .convert import params_from_jax
from .generation import GenerationConfig
from .modeling_utils import PreTrainedModel
from .models.auto import AutoConfig, AutoModelForCausalLM
from .models.gemma import GemmaConfig, GemmaForCausalLM
from .models.gemma2 import Gemma2Config, Gemma2ForCausalLM
from .models.gemma3 import Gemma3ForCausalLM, Gemma3TextConfig
from .models.llama import LlamaConfig, LlamaForCausalLM
from .models.mistral import MistralConfig, MistralForCausalLM
from .models.mixtral import MixtralConfig, MixtralForCausalLM
from .models.phi3 import Phi3Config, Phi3ForCausalLM
from .models.qwen2 import Qwen2Config, Qwen2ForCausalLM
from .models.qwen2_moe import Qwen2MoeConfig, Qwen2MoeForCausalLM
from .models.qwen3 import Qwen3Config, Qwen3ForCausalLM
from .models.qwen3_moe import Qwen3MoeConfig, Qwen3MoeForCausalLM
from .quantizers import (Fp8WeightOnlyConfig, Int4WeightOnlyConfig, Int8WeightOnlyConfig,
                         QuantizationConfig, quantize_params)
from .tokenization import AutoTokenizer, BatchEncoding, PreTrainedTokenizer
from .trainer import Trainer
from .trainer_callback import TrainerCallback
from .training_args import TrainingArguments
