"""RoBERTa config (port of transformers_tpu/models/roberta/configuration_roberta.py;
reference src/transformers/models/roberta/configuration_roberta.py)."""

from __future__ import annotations

from ..bert.configuration_bert import BertConfig


class RobertaConfig(BertConfig):
    model_type = "roberta"

    def __init__(self, pad_token_id=1, bos_token_id=0, eos_token_id=2, **kwargs):
        super().__init__(pad_token_id=pad_token_id, bos_token_id=bos_token_id,
                         eos_token_id=eos_token_id, **kwargs)
