from .base import QuantizationConfig, get_quantizer, quantize_params
from .weight_only import Fp8WeightOnlyConfig, Int4WeightOnlyConfig, Int8WeightOnlyConfig
