from .auto import AutoTokenizer
from .base import BatchEncoding, PreTrainedTokenizer
from .engine import TokenizerEngine
