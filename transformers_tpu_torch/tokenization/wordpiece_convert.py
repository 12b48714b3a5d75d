"""Legacy BERT vocab.txt -> engine config (a copy of
``transformers_tpu/tokenization/wordpiece_convert.py``; reference
convert_slow_tokenizer.py BertConverter): BertNormalizer + BertPreTokenizer +
WordPiece model + [CLS] $A [SEP] template, with options read from
tokenizer_config.json (do_lower_case, strip_accents, tokenize_chinese_chars).
"""

from __future__ import annotations

from typing import Optional


def vocab_txt_to_tokenizer_config(vocab_lines: list[str], tokenizer_config: Optional[dict] = None) -> dict:
    cfg = tokenizer_config or {}
    vocab = {tok: i for i, tok in enumerate(vocab_lines)}

    def tok_str(name, default):
        v = cfg.get(name, default)
        return v["content"] if isinstance(v, dict) else (v or default)

    unk = tok_str("unk_token", "[UNK]")
    cls_tok = tok_str("cls_token", "[CLS]")
    sep_tok = tok_str("sep_token", "[SEP]")
    pad_tok = tok_str("pad_token", "[PAD]")
    mask_tok = tok_str("mask_token", "[MASK]")

    added = [
        {"id": vocab[t], "content": t, "special": True}
        for t in (pad_tok, unk, cls_tok, sep_tok, mask_tok) if t in vocab
    ]

    return {
        "version": "1.0",
        "added_tokens": added,
        "normalizer": {
            "type": "BertNormalizer",
            "clean_text": True,
            "handle_chinese_chars": cfg.get("tokenize_chinese_chars", True),
            "strip_accents": cfg.get("strip_accents", None),
            "lowercase": cfg.get("do_lower_case", True),
        },
        "pre_tokenizer": {"type": "BertPreTokenizer"},
        "model": {
            "type": "WordPiece",
            "unk_token": unk,
            "continuing_subword_prefix": "##",
            "max_input_chars_per_word": 100,
            "vocab": vocab,
        },
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [
                {"SpecialToken": {"id": cls_tok, "type_id": 0}},
                {"Sequence": {"id": "A", "type_id": 0}},
                {"SpecialToken": {"id": sep_tok, "type_id": 0}},
            ],
            "pair": [
                {"SpecialToken": {"id": cls_tok, "type_id": 0}},
                {"Sequence": {"id": "A", "type_id": 0}},
                {"SpecialToken": {"id": sep_tok, "type_id": 0}},
                {"Sequence": {"id": "B", "type_id": 1}},
                {"SpecialToken": {"id": sep_tok, "type_id": 1}},
            ],
            "special_tokens": {
                cls_tok: {"id": cls_tok, "ids": [vocab.get(cls_tok, 0)], "tokens": [cls_tok]},
                sep_tok: {"id": sep_tok, "ids": [vocab.get(sep_tok, 0)], "tokens": [sep_tok]},
            },
        },
        "decoder": {"type": "WordPiece", "prefix": "##", "cleanup": True},
    }
