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
from .models.llama import LlamaConfig, LlamaForCausalLM
from .quantizers import (Fp8WeightOnlyConfig, Int4WeightOnlyConfig, Int8WeightOnlyConfig,
                         QuantizationConfig, quantize_params)
from .trainer import Trainer
from .trainer_callback import TrainerCallback
from .training_args import TrainingArguments
