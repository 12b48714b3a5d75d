"""Solar-Open decoder (port of transformers_tpu/models/solar_open/modeling_solar_open.py;
reference src/transformers/models/solar_open/modular_solar_open.py).

GLM-4.5's MoE stack with full rotary (so K2 serves its static decode), no
q/k norm and, by the config's default ``first_k_dense_replace`` of 0, the
sigmoid group-routed experts plus shared experts on every layer.
Checkpoints hold one tensor per expert (``mlp.experts.N.gate_proj``).
"""

from __future__ import annotations

from ..glm4_moe.modeling_glm4_moe import Glm4MoeForCausalLM, Glm4MoeModel
from ..llama.modeling_llama import LlamaModelStandalone
from .configuration_solar_open import SolarOpenConfig


class SolarOpenForCausalLM(Glm4MoeForCausalLM):
    config_class = SolarOpenConfig


class SolarOpenModelStandalone(LlamaModelStandalone):
    config_class = SolarOpenConfig
    model_cls = Glm4MoeModel
