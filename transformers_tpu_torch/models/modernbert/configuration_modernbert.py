"""ModernBERT config (port of
transformers_tpu/models/modernbert/configuration_modernbert.py; reference
src/transformers/models/modernbert/configuration_modernbert.py)."""

from __future__ import annotations

from ...configuration_utils import PretrainedConfig


class ModernBertConfig(PretrainedConfig):
    model_type = "modernbert"

    def __init__(
        self,
        vocab_size=50368,
        hidden_size=768,
        intermediate_size=1152,
        num_hidden_layers=22,
        num_attention_heads=12,
        hidden_activation="gelu",
        max_position_embeddings=8192,
        initializer_range=0.02,
        initializer_cutoff_factor=2.0,
        norm_eps=1e-5,
        norm_bias=False,
        pad_token_id=50283,
        eos_token_id=50282,
        bos_token_id=50281,
        cls_token_id=50281,
        sep_token_id=50282,
        global_rope_theta=160000.0,
        attention_bias=False,
        attention_dropout=0.0,
        global_attn_every_n_layers=3,
        local_attention=128,
        local_rope_theta=10000.0,
        embedding_dropout=0.0,
        mlp_bias=False,
        mlp_dropout=0.0,
        decoder_bias=True,
        classifier_pooling="cls",
        classifier_dropout=0.0,
        classifier_bias=False,
        classifier_activation="gelu",
        sparse_prediction=False,
        sparse_pred_ignore_index=-100,
        layer_types=None,
        tie_word_embeddings=True,
        **kwargs,
    ):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.hidden_activation = hidden_activation
        self.max_position_embeddings = max_position_embeddings
        self.initializer_range = initializer_range
        self.initializer_cutoff_factor = initializer_cutoff_factor
        self.norm_eps = norm_eps
        self.norm_bias = norm_bias
        self.global_rope_theta = global_rope_theta
        self.attention_bias = attention_bias
        self.attention_dropout = attention_dropout
        self.global_attn_every_n_layers = global_attn_every_n_layers
        self.local_attention = local_attention
        self.local_rope_theta = local_rope_theta
        self.embedding_dropout = embedding_dropout
        self.mlp_bias = mlp_bias
        self.mlp_dropout = mlp_dropout
        self.decoder_bias = decoder_bias
        self.classifier_pooling = classifier_pooling
        self.classifier_dropout = classifier_dropout
        self.classifier_bias = classifier_bias
        self.classifier_activation = classifier_activation
        self.sparse_prediction = sparse_prediction
        self.sparse_pred_ignore_index = sparse_pred_ignore_index
        self.layer_types = layer_types
        if self.layer_types is None:
            self.layer_types = [
                "sliding_attention" if bool(i % global_attn_every_n_layers) else "full_attention"
                for i in range(num_hidden_layers)
            ]
        super().__init__(
            pad_token_id=pad_token_id, eos_token_id=eos_token_id,
            bos_token_id=bos_token_id, cls_token_id=cls_token_id,
            sep_token_id=sep_token_id, tie_word_embeddings=tie_word_embeddings,
            **kwargs,
        )

    @property
    def sliding_window(self):
        """Half-window size (reference :160): local_attention is the total
        window; the bidirectional mask uses inclusive distance <= this."""
        return self.local_attention // 2
