"""Gemma3 text config (port of ``Gemma3TextConfig`` in
transformers_tpu/models/gemma3/configuration_gemma3.py; the multimodal
``Gemma3Config`` is not ported yet)."""

from __future__ import annotations

from ..gemma2.configuration_gemma2 import Gemma2Config


class Gemma3TextConfig(Gemma2Config):
    """Gemma-2's config with Gemma-3's defaults: no softcaps, every
    ``sliding_window_pattern``-th layer global, and a local rope base for the
    sliding layers."""

    model_type = "gemma3_text"

    def __init__(self, vocab_size=262208, max_position_embeddings=131072,
                 rope_theta=1_000_000.0, rope_local_base_freq=10_000.0, layer_types=None,
                 sliding_window_pattern=6, final_logit_softcapping=None,
                 attn_logit_softcapping=None, **kwargs):
        self.rope_local_base_freq = rope_local_base_freq
        self.sliding_window_pattern = sliding_window_pattern
        super().__init__(vocab_size=vocab_size, max_position_embeddings=max_position_embeddings,
                         rope_theta=rope_theta, layer_types=layer_types,
                         final_logit_softcapping=final_logit_softcapping,
                         attn_logit_softcapping=attn_logit_softcapping, **kwargs)
        if layer_types is None:  # every Nth layer is global (reference layer_types default)
            self.layer_types = [
                "sliding_attention" if bool((i + 1) % sliding_window_pattern) else "full_attention"
                for i in range(self.num_hidden_layers)
            ]
