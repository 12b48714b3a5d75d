from .configuration_utils import GenerationConfig
from .utils import GenerationMixin
