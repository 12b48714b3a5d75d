from .configuration_dots1 import Dots1Config
from .modeling_dots1 import Dots1DecoderLayer, Dots1ForCausalLM, Dots1Model, Dots1ModelStandalone
