"""ERNIE-4.5 config (port of transformers_tpu/models/ernie4_5/configuration_ernie4_5.py)."""

from __future__ import annotations

from ..llama.configuration_llama import LlamaConfig


class Ernie4_5Config(LlamaConfig):
    """Llama's config with one ``use_bias`` switch for every attention and MLP
    projection and tied word embeddings by default."""

    model_type = "ernie4_5"

    def __init__(self, use_bias=False, **kwargs):
        self.use_bias = use_bias
        kwargs.setdefault("tie_word_embeddings", True)
        super().__init__(**kwargs)
