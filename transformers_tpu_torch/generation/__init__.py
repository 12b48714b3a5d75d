from .configuration_utils import GenerationConfig
from .utils import GenerationMixin
from .beam_search import build_beam_search_fn
from .candidate_generator import AssistedDecoder, assisted_generate
from .watermarking import (SynthIDTextWatermarkDetector, SynthIDTextWatermarkLogitsProcessor,
                           WatermarkDetector, WatermarkLogitsProcessor)
