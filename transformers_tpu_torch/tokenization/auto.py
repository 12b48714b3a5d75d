"""AutoTokenizer (port of ``transformers_tpu/tokenization/auto.py``; reference
models/auto/tokenization_auto.py).

Every tokenizer.json checkpoint shares one engine, so AutoTokenizer is thin.
The JAX package dispatches a few tokenizers of other kinds (VITS, ByT5,
BERTweet, ...) by the ``tokenizer_class`` in tokenizer_config.json to its
model families; the port has none of those families yet and raises for them
rather than loading them as a tokenizer.json they are not.
"""

from __future__ import annotations

import json

from ..utils.hub import TOKENIZER_CONFIG_FILE, cached_file
from .base import PreTrainedTokenizer

# tokenizer_class names the JAX package loads through its model families
UNPORTED_TOKENIZERS = frozenset({
    "VitsTokenizer", "ByT5Tokenizer", "BertweetTokenizer", "PhobertTokenizer",
    "HerbertTokenizer", "HerbertTokenizerFast", "MyT5Tokenizer", "BertJapaneseTokenizer",
    "CpmTokenizer", "CodeLlamaTokenizer", "MBart50Tokenizer", "MBart50TokenizerFast",
})


class AutoTokenizer:
    def __init__(self):
        raise OSError("Use AutoTokenizer.from_pretrained(...)")

    @classmethod
    def from_pretrained(cls, path_or_repo, **kwargs) -> PreTrainedTokenizer:
        cfg_file = cached_file(path_or_repo, TOKENIZER_CONFIG_FILE, required=False)
        if cfg_file:
            with open(cfg_file, encoding="utf-8") as f:
                tok_class = json.load(f).get("tokenizer_class")
            if tok_class in UNPORTED_TOKENIZERS:
                raise NotImplementedError(
                    f"{path_or_repo}: tokenizer_class {tok_class} belongs to a model family "
                    f"the port does not have yet")
        return PreTrainedTokenizer.from_pretrained(path_or_repo, **kwargs)
