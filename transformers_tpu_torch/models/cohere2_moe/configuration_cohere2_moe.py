"""Cohere2-MoE config (port of
transformers_tpu/models/cohere2_moe/configuration_cohere2_moe.py)."""

from __future__ import annotations

from ..cohere2.configuration_cohere2 import Cohere2Config


class Cohere2MoeConfig(Cohere2Config):
    """Cohere2's config with experts: ``num_experts`` of ``intermediate_size``,
    ``num_experts_per_tok`` a token picked on the raw logits and weighted by
    their softmax, or their sigmoid (renormalized when ``norm_topk_prob``)
    (``expert_selection_fn``); ``num_shared_experts`` shared ones combined by
    ``sum`` or ``average``; ``first_k_dense_replace`` dense prefix layers at
    ``prefix_dense_intermediate_size`` with their own window pattern
    (``prefix_dense_sliding_window_pattern``; 1 keeps rope on every dense
    layer); RMSNorms instead of LayerNorms where ``rms_norm_eps`` is set."""

    model_type = "cohere2_moe"

    def __init__(self, num_experts_per_tok=2, num_experts=8, num_shared_experts=0,
                 shared_expert_combination_strategy="average", expert_selection_fn="softmax",
                 layer_types=None, mlp_layer_types=None, prefix_dense_sliding_window_pattern=1,
                 norm_topk_prob=True, prefix_dense_intermediate_size=None, rms_norm_eps=None,
                 first_k_dense_replace=0, sliding_window_pattern=4, **kwargs):
        self.num_experts_per_tok = num_experts_per_tok
        self.num_experts = num_experts
        self.num_shared_experts = num_shared_experts
        self.shared_expert_combination_strategy = shared_expert_combination_strategy
        self.expert_selection_fn = expert_selection_fn
        self.prefix_dense_sliding_window_pattern = prefix_dense_sliding_window_pattern
        self.norm_topk_prob = norm_topk_prob
        self.prefix_dense_intermediate_size = prefix_dense_intermediate_size
        if layer_types is None:
            n = kwargs.get("num_hidden_layers", 40)
            prefix = ["sliding_attention" if (i + 1) % prefix_dense_sliding_window_pattern != 0
                      else "full_attention" for i in range(first_k_dense_replace)]
            rest = ["sliding_attention" if (i + 1) % sliding_window_pattern != 0
                    else "full_attention" for i in range(n - first_k_dense_replace)]
            layer_types = prefix + rest
        super().__init__(layer_types=layer_types, sliding_window_pattern=sliding_window_pattern,
                         **kwargs)
        self.rms_norm_eps = rms_norm_eps
        if mlp_layer_types is None:
            mlp_layer_types = ["dense" if i < first_k_dense_replace else "sparse"
                               for i in range(self.num_hidden_layers)]
        self.mlp_layer_types = mlp_layer_types
