"""Phi-3 config (port of transformers_tpu/models/phi3/configuration_phi3.py)."""

from __future__ import annotations

from ..llama.configuration_llama import LlamaConfig


class Phi3Config(LlamaConfig):
    """Llama's config with Phi-3-mini's defaults and LongRoPE's original
    context length."""

    model_type = "phi3"

    def __init__(self, vocab_size=32064, hidden_size=3072, intermediate_size=8192,
                 resid_pdrop=0.0, embd_pdrop=0.0, max_position_embeddings=4096,
                 original_max_position_embeddings=4096, rms_norm_eps=1e-5, eos_token_id=32000,
                 pad_token_id=32000, sliding_window=None, **kwargs):
        self.resid_pdrop = resid_pdrop
        self.embd_pdrop = embd_pdrop
        self.original_max_position_embeddings = original_max_position_embeddings
        self.sliding_window = sliding_window
        super().__init__(vocab_size=vocab_size, hidden_size=hidden_size,
                         intermediate_size=intermediate_size,
                         max_position_embeddings=max_position_embeddings,
                         rms_norm_eps=rms_norm_eps, eos_token_id=eos_token_id,
                         pad_token_id=pad_token_id, **kwargs)
