"""Cohere2 (Command-R7B) config (port of the config in
transformers_tpu/models/cohere2/modeling_cohere2.py)."""

from __future__ import annotations

from ..cohere.configuration_cohere import CohereConfig


class Cohere2Config(CohereConfig):
    """Cohere's config with a layer pattern: every ``sliding_window_pattern``-th
    layer full attention with no rope, the others sliding at
    ``sliding_window`` with rope (``layer_types``); no q/k norms."""

    model_type = "cohere2"

    def __init__(self, sliding_window=4096, sliding_window_pattern=4, layer_types=None,
                 **kwargs):
        kwargs.pop("use_qk_norm", None)
        super().__init__(**kwargs)
        self.sliding_window = sliding_window
        self.sliding_window_pattern = sliding_window_pattern
        if layer_types is None:
            layer_types = ["full_attention" if (i + 1) % sliding_window_pattern == 0
                           else "sliding_attention" for i in range(self.num_hidden_layers)]
        self.layer_types = layer_types
