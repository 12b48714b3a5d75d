"""Tokenizer user-facing API (port of ``transformers_tpu/tokenization/base.py``).

Reference src/transformers/tokenization_utils_base.py
(``PreTrainedTokenizerBase`` :962 — __call__/encode/decode, ``BatchEncoding``
:195, from_pretrained :1489, apply_chat_template :2989), backed by the
tokenizer.json engine (engine.py). ``return_tensors="pt"`` gives torch
tensors (int64) and ``BatchEncoding.to(device)`` moves them, where the JAX
package has ``"jax"`` and ``to_jax``; ``"np"`` gives int32 arrays as there.
Checkpoints are read from local directories only (utils/hub.py).
"""

from __future__ import annotations

import json
import os
from collections import UserDict
from typing import Any, Iterable, Optional, Union

import numpy as np
import torch

from ..utils.hub import (
    CHAT_TEMPLATE_FILE,
    SPECIAL_TOKENS_MAP_FILE,
    TOKENIZER_CONFIG_FILE,
    TOKENIZER_FILE,
    cached_file,
)
from .engine import TokenizerEngine

SPECIAL_TOKEN_ATTRS = [
    "bos_token", "eos_token", "unk_token", "sep_token", "pad_token", "cls_token",
    "mask_token", "additional_special_tokens",
]


class BatchEncoding(UserDict):
    """Dict of encoded outputs with attribute access (reference
    tokenization_utils_base.py:195). Values are lists, numpy arrays or torch
    tensors."""

    def __getattr__(self, item):
        try:
            return self.data[item]
        except KeyError:
            raise AttributeError(item)

    def to_numpy(self) -> "BatchEncoding":
        return BatchEncoding({k: np.asarray(v) for k, v in self.data.items()})

    def to(self, device) -> "BatchEncoding":
        """The torch tensors moved to ``device``; other values as they are."""
        return BatchEncoding({k: v.to(device) if isinstance(v, torch.Tensor) else v
                              for k, v in self.data.items()})


def _as_tensors(data: dict, return_tensors: Optional[str], np_dtype=None) -> dict:
    """``data``'s rectangular values as numpy arrays of ``np_dtype`` (``"np"``)
    or torch tensors, int64 for ids (``"pt"``); ragged values stay lists."""
    if return_tensors is None:
        return data
    if return_tensors not in ("np", "pt"):
        raise ValueError(f"return_tensors={return_tensors!r}: the port gives 'np' or 'pt'")
    out = {}
    for k, v in data.items():
        try:
            arr = np.asarray(v, dtype=np_dtype)
        except ValueError:  # ragged
            out[k] = v
            continue
        if return_tensors == "pt":
            arr = torch.as_tensor(arr.astype(np.int64) if arr.dtype == np.int32 else arr)
        out[k] = arr
    return out


def _token_content(tok) -> Optional[str]:
    if tok is None:
        return None
    if isinstance(tok, str):
        return tok
    if isinstance(tok, dict):
        return tok.get("content")
    return str(tok)


def _looks_like_tiktoken(blob: bytes) -> bool:
    """tiktoken rank files are ASCII ``base64 rank`` lines; SentencePiece
    .model files are binary protobuf."""
    head = blob[:4096]
    if b"\x00" in head:
        return False
    import re as _re

    lines = [l for l in head.split(b"\n") if l.strip()][:5]
    if not lines:
        return False
    return all(_re.fullmatch(rb"[A-Za-z0-9+/=]+ \d+", l.strip()) for l in lines)


class PreTrainedTokenizer:
    """tokenizer.json-backed tokenizer with the reference's call contract."""

    padding_side = "left"  # decoder-only default; models may override via config

    def __init__(
        self,
        engine: TokenizerEngine,
        *,
        tokenizer_config: Optional[dict] = None,
        chat_template: Optional[str] = None,
        name_or_path: str = "",
    ):
        self.engine = engine
        self.tokenizer_config = tokenizer_config or {}
        self.chat_template = chat_template or self.tokenizer_config.get("chat_template")
        self.name_or_path = name_or_path
        self.padding_side = self.tokenizer_config.get("padding_side", type(self).padding_side)
        self.model_max_length = self.tokenizer_config.get("model_max_length", int(1e30))

        for attr in SPECIAL_TOKEN_ATTRS:
            val = self.tokenizer_config.get(attr)
            if attr == "additional_special_tokens":
                setattr(self, attr, [_token_content(t) for t in (val or [])])
            else:
                setattr(self, attr, _token_content(val))
        if self.pad_token is None and self.eos_token is not None:
            self.pad_token = self.eos_token
        # declarative output-structure spec (reference tokenization_utils_base.py:1084)
        self.response_template = self.tokenizer_config.get("response_template")

    # ------------------------------------------------------------------- IO
    @classmethod
    def from_pretrained(cls, path_or_repo, **kwargs) -> "PreTrainedTokenizer":
        tok_file = cached_file(str(path_or_repo), TOKENIZER_FILE, required=False)
        if tok_file:
            engine = TokenizerEngine.from_file(tok_file)
        else:
            # Mistral tekken.json (reference tokenization_mistral_common.py)
            tekken_file = cached_file(str(path_or_repo), "tekken.json", required=False)
            if tekken_file:
                from .tiktoken_convert import convert_tekken

                engine = TokenizerEngine(convert_tekken(tekken_file))
                return cls._from_engine(engine, path_or_repo, kwargs)
            # SentencePiece fallback (reference convert_slow_tokenizer.py
            # SpmConverter): parse the .model protobuf, build the same engine
            spm_file = None
            for name in ("tokenizer.model", "spiece.model", "sentencepiece.bpe.model"):
                spm_file = cached_file(str(path_or_repo), name, required=False)
                if spm_file:
                    break
            if spm_file:
                with open(spm_file, "rb") as f:
                    blob = f.read()
                if _looks_like_tiktoken(blob):
                    # Llama-3-era checkpoints ship tiktoken ranks under the
                    # same tokenizer.model name (reference TikTokenConverter)
                    from .tiktoken_convert import convert_tiktoken

                    engine = TokenizerEngine(convert_tiktoken(spm_file))
                else:
                    from .spm import spm_to_tokenizer_config

                    engine = TokenizerEngine(spm_to_tokenizer_config(blob))
            else:
                # Legacy WordPiece fallback (reference BertConverter): build
                # the engine from vocab.txt + tokenizer_config options.
                vocab_file = cached_file(str(path_or_repo), "vocab.txt", required=False)
                if not vocab_file:
                    raise OSError(
                        f"No tokenizer.json, sentencepiece .model, or vocab.txt found at {path_or_repo}")
                cfg_file_ = cached_file(str(path_or_repo), TOKENIZER_CONFIG_FILE, required=False)
                tok_cfg = {}
                if cfg_file_:
                    with open(cfg_file_, encoding="utf-8") as f:
                        tok_cfg = json.load(f)
                from .wordpiece_convert import vocab_txt_to_tokenizer_config

                with open(vocab_file, encoding="utf-8") as f:
                    lines = [l.rstrip("\n") for l in f if l.strip("\n") != ""]
                engine = TokenizerEngine(vocab_txt_to_tokenizer_config(lines, tok_cfg))
                # BertTokenizer hardcodes these defaults in code, not config
                # (reference tokenization_bert.py __init__ signature).
                for attr, default in (("unk_token", "[UNK]"), ("sep_token", "[SEP]"),
                                      ("pad_token", "[PAD]"), ("cls_token", "[CLS]"),
                                      ("mask_token", "[MASK]")):
                    kwargs.setdefault(attr, tok_cfg.get(attr, default))
        return cls._from_engine(engine, path_or_repo, kwargs)

    @classmethod
    def _from_engine(cls, engine, path_or_repo, kwargs):
        config = {}
        cfg_file = cached_file(str(path_or_repo), TOKENIZER_CONFIG_FILE, required=False)
        if cfg_file:
            with open(cfg_file, encoding="utf-8") as f:
                config = json.load(f)
        spec_file = cached_file(str(path_or_repo), SPECIAL_TOKENS_MAP_FILE, required=False)
        if spec_file:
            with open(spec_file, encoding="utf-8") as f:
                special = json.load(f)
            for k, v in special.items():
                config.setdefault(k, v)
        chat_file = cached_file(str(path_or_repo), CHAT_TEMPLATE_FILE, required=False)
        chat_template = None
        if chat_file:
            with open(chat_file, encoding="utf-8") as f:
                chat_template = f.read()
        config.update(kwargs)
        return cls(engine, tokenizer_config=config, chat_template=chat_template,
                   name_or_path=str(path_or_repo))

    def save_pretrained(self, save_directory) -> None:
        os.makedirs(save_directory, exist_ok=True)
        with open(os.path.join(save_directory, TOKENIZER_FILE), "w", encoding="utf-8") as f:
            json.dump(self.engine.config, f, ensure_ascii=False)
        cfg = dict(self.tokenizer_config)
        cfg["padding_side"] = self.padding_side
        for attr in SPECIAL_TOKEN_ATTRS:
            v = getattr(self, attr, None)
            if v is not None:
                cfg[attr] = v
        if self.chat_template is not None:
            with open(os.path.join(save_directory, CHAT_TEMPLATE_FILE), "w", encoding="utf-8") as f:
                f.write(self.chat_template)
            cfg.pop("chat_template", None)
        with open(os.path.join(save_directory, TOKENIZER_CONFIG_FILE), "w", encoding="utf-8") as f:
            json.dump(cfg, f, indent=2, ensure_ascii=False, default=str)

    # ---------------------------------------------------------------- basics
    @property
    def vocab_size(self) -> int:
        return len(self.engine.model.vocab)

    def __len__(self) -> int:
        return len(self.engine.vocab)

    def get_vocab(self) -> dict[str, int]:
        return dict(self.engine.vocab)

    def convert_tokens_to_ids(self, tokens):
        if isinstance(tokens, str):
            return self.engine.vocab.get(tokens)
        return [self.engine.vocab.get(t) for t in tokens]

    def convert_ids_to_tokens(self, ids):
        if isinstance(ids, int):
            return self.engine.id_to_token.get(ids)
        return self.engine.convert_ids_to_tokens(ids)

    @property
    def bos_token_id(self):
        return self.convert_tokens_to_ids(self.bos_token) if self.bos_token else None

    @property
    def eos_token_id(self):
        return self.convert_tokens_to_ids(self.eos_token) if self.eos_token else None

    @property
    def pad_token_id(self):
        return self.convert_tokens_to_ids(self.pad_token) if self.pad_token else None

    @property
    def unk_token_id(self):
        return self.convert_tokens_to_ids(self.unk_token) if self.unk_token else None

    @property
    def cls_token_id(self):
        return self.convert_tokens_to_ids(self.cls_token) if self.cls_token else None

    @property
    def sep_token_id(self):
        return self.convert_tokens_to_ids(self.sep_token) if self.sep_token else None

    @property
    def all_special_ids(self) -> list[int]:
        return sorted(self.engine.special_ids)

    # ---------------------------------------------------------------- encode
    def tokenize(self, text: str, add_special_tokens: bool = False) -> list[str]:
        enc = self.engine.encode(text, add_special_tokens=add_special_tokens)
        return self.engine.convert_ids_to_tokens(enc["input_ids"])

    def encode(self, text: str, text_pair: Optional[str] = None, add_special_tokens: bool = True,
               **kwargs) -> list[int]:
        return self.engine.encode(text, text_pair, add_special_tokens)["input_ids"]

    def __call__(
        self,
        text: Union[str, list[str]],
        text_pair: Optional[Union[str, list[str]]] = None,
        *,
        add_special_tokens: bool = True,
        padding: Union[bool, str] = False,
        truncation: Union[bool, str] = False,
        max_length: Optional[int] = None,
        return_tensors: Optional[str] = None,
        return_attention_mask: bool = True,
        return_token_type_ids: bool = False,
        pad_to_multiple_of: Optional[int] = None,
        **kwargs,
    ) -> BatchEncoding:
        """reference tokenization_utils_base.py:962 main entry."""
        is_batched = isinstance(text, (list, tuple))
        texts = list(text) if is_batched else [text]
        pairs = list(text_pair) if isinstance(text_pair, (list, tuple)) else (
            [text_pair] * len(texts) if text_pair is not None else [None] * len(texts))

        encoded = [self.engine.encode(t, p, add_special_tokens) for t, p in zip(texts, pairs)]
        ids_list = [e["input_ids"] for e in encoded]
        type_ids_list = [e["token_type_ids"] for e in encoded]

        if truncation and max_length:
            ids_list = [ids[:max_length] for ids in ids_list]
            type_ids_list = [t[:max_length] for t in type_ids_list]

        mask_list = [[1] * len(ids) for ids in ids_list]

        do_pad = padding is True or padding in ("longest", "max_length")
        if do_pad:
            target = max_length if padding == "max_length" and max_length else max(len(i) for i in ids_list)
            if pad_to_multiple_of:
                target = -(-target // pad_to_multiple_of) * pad_to_multiple_of
            pad_id = self.pad_token_id if self.pad_token_id is not None else 0
            for i in range(len(ids_list)):
                diff = target - len(ids_list[i])
                if diff <= 0:
                    continue
                if self.padding_side == "left":
                    ids_list[i] = [pad_id] * diff + ids_list[i]
                    mask_list[i] = [0] * diff + mask_list[i]
                    type_ids_list[i] = [0] * diff + type_ids_list[i]
                else:
                    ids_list[i] = ids_list[i] + [pad_id] * diff
                    mask_list[i] = mask_list[i] + [0] * diff
                    type_ids_list[i] = type_ids_list[i] + [0] * diff

        data: dict[str, Any] = {"input_ids": ids_list if is_batched else ids_list[0]}
        if return_attention_mask:
            data["attention_mask"] = mask_list if is_batched else mask_list[0]
        if return_token_type_ids:
            data["token_type_ids"] = type_ids_list if is_batched else type_ids_list[0]

        if return_tensors is not None:
            lens = {len(i) for i in ids_list}
            if len(lens) > 1:
                raise ValueError("Cannot build a tensor from ragged sequences; pass padding=True.")
            data = _as_tensors({k: v if is_batched else [v] for k, v in data.items()},
                               return_tensors, np.int32)
        return BatchEncoding(data)

    # ---------------------------------------------------------------- decode
    def decode(self, token_ids, skip_special_tokens: bool = False,
               clean_up_tokenization_spaces: bool = False, **kwargs) -> str:
        if hasattr(token_ids, "tolist"):
            token_ids = token_ids.tolist()
        if token_ids and isinstance(token_ids[0], (list, tuple)):
            raise ValueError("decode() takes one sequence; use batch_decode().")
        text = self.engine.decode(token_ids, skip_special_tokens)
        if clean_up_tokenization_spaces:
            for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
                         (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"), (" 're", "'re")):
                text = text.replace(a, b)
        return text

    def batch_decode(self, sequences, **kwargs) -> list[str]:
        if hasattr(sequences, "tolist"):
            sequences = sequences.tolist()
        return [self.decode(s, **kwargs) for s in sequences]

    # ----------------------------------------------------------- chat template
    def apply_chat_template(
        self,
        conversation: list[dict],
        *,
        chat_template: Optional[str] = None,
        add_generation_prompt: bool = False,
        tokenize: bool = True,
        return_tensors: Optional[str] = None,
        tools: Optional[list] = None,
        **kwargs,
    ):
        """reference tokenization_utils_base.py:2989 (jinja sandbox render).
        Needs the ``jinja2`` package, imported here and not with the module."""
        template = chat_template or self.chat_template
        if template is None:
            raise ValueError(f"{self.name_or_path} has no chat template.")
        from jinja2.sandbox import ImmutableSandboxedEnvironment

        def raise_exception(message):
            raise ValueError(message)

        if tools is not None:
            from ..utils.chat_template_utils import get_json_schema

            tools = [get_json_schema(t) if callable(t) else t for t in tools]
        env = ImmutableSandboxedEnvironment(trim_blocks=True, lstrip_blocks=True)
        env.globals["raise_exception"] = raise_exception
        env.filters["tojson"] = lambda x, **kw: json.dumps(x, **kw)
        compiled = env.from_string(template)
        rendered = compiled.render(
            messages=conversation,
            tools=tools,
            add_generation_prompt=add_generation_prompt,
            bos_token=self.bos_token,
            eos_token=self.eos_token,
            pad_token=self.pad_token,
            **kwargs,
        )
        if not tokenize:
            return rendered
        return self(rendered, add_special_tokens=False, return_tensors=return_tensors)["input_ids"]

    def parse_response(self, response, response_template=None, *,
                       prefix: Optional[str] = None, tools=None) -> dict:
        """Structured parsing of a chat response by a ``response_template``
        (reference tokenization_utils_base.py:3337) is not ported yet: the JAX
        package's ``utils/chat_parsing.py`` comes with the port's first Qwen
        family (ROADMAP A10), with its own answer to the ``regex`` module's
        partial matching."""
        raise NotImplementedError(
            "parse_response (utils/chat_parsing.py, tool-call and reasoning parsing) is not "
            "ported yet; it comes with the first Qwen-family slice of the port")

    @property
    def mask_token_id(self):
        tok = getattr(self, "mask_token", None)
        return self.convert_tokens_to_ids(tok) if tok else None

    def pad(self, encoded_inputs, padding=True, max_length=None,
            pad_to_multiple_of=None, return_tensors=None, **kwargs) -> BatchEncoding:
        """Pad pre-tokenized features (reference tokenization_utils_base.py pad).

        Accepts a list of dicts or a dict of lists with at least input_ids."""
        if isinstance(encoded_inputs, (list, tuple)):
            keys = encoded_inputs[0].keys()
            batch = {k: [e[k] for e in encoded_inputs] for k in keys}
        else:
            batch = {k: list(v) for k, v in encoded_inputs.items()}
        ids_list = [list(np.asarray(i).tolist()) for i in batch["input_ids"]]
        mask_list = [list(np.asarray(m).tolist()) for m in batch.get(
            "attention_mask", [[1] * len(i) for i in ids_list])]
        target = max(len(i) for i in ids_list)
        if padding == "max_length" and max_length:
            target = max_length
        if pad_to_multiple_of:
            target = -(-target // pad_to_multiple_of) * pad_to_multiple_of
        pad_id = self.pad_token_id if self.pad_token_id is not None else 0
        extras = {k: v for k, v in batch.items() if k not in ("input_ids", "attention_mask")}
        for i in range(len(ids_list)):
            diff = target - len(ids_list[i])
            if diff <= 0:
                continue
            if self.padding_side == "left":
                ids_list[i] = [pad_id] * diff + ids_list[i]
                mask_list[i] = [0] * diff + mask_list[i]
            else:
                ids_list[i] = ids_list[i] + [pad_id] * diff
                mask_list[i] = mask_list[i] + [0] * diff
        data = {"input_ids": ids_list, "attention_mask": mask_list}
        for k, v in extras.items():
            data[k] = v
        return BatchEncoding(_as_tensors(data, return_tensors))
