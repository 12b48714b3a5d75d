"""Tiktoken / Mistral-tekken checkpoint readers.

A copy of ``transformers_tpu/tokenization/tiktoken_convert.py``: the reference
converters that bring OpenAI-style BPE
rank files into the engine:

- ``convert_tiktoken``: reference convert_slow_tokenizer.py TikTokenConverter
  (:1903-1978). A ``.tiktoken``/``tokenizer.model`` rank file is lines of
  ``base64(token) rank``; merges are recovered by splitting every multi-byte
  token at each position and keeping splits whose halves are themselves
  tokens, ordered by (left rank, right rank) then by merged rank (:1937-1951).
- ``convert_tekken``: reference tokenization_mistral_common.py checkpoints
  ship ``tekken.json`` — a JSON with a config block (pattern, vocab sizes,
  number of reserved special slots), a base64 vocab ranked list, and special
  tokens; regular token ids are offset by the special-token count.

Both return an engine-interpretable tokenizer.json dict (byte-level BPE with
``ignore_merges``), so no Rust/tiktoken dependency is needed anywhere.
"""

from __future__ import annotations

import base64
import json

GPT4_PATTERN = (r"""(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"""
                r"""|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+""")


def bytes_to_unicode():
    """GPT-2 byte<->unicode table (reference models/gpt2/tokenization_gpt2.py)."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _token_bytes_to_string(b: bytes, table) -> str:
    return "".join(table[byte] for byte in b)


def _ranks_to_vocab_merges(bpe_ranks: dict[bytes, int]):
    table = bytes_to_unicode()
    vocab = {}
    merges = []
    for token, rank in bpe_ranks.items():
        vocab[_token_bytes_to_string(token, table)] = rank
        if len(token) == 1:
            continue
        local = []
        for index in range(1, len(token)):
            left, right = token[:index], token[index:]
            if left in bpe_ranks and right in bpe_ranks and (left + right) in bpe_ranks:
                local.append((left, right, rank))
        local.sort(key=lambda x: (bpe_ranks[x[0]], bpe_ranks[x[1]]))
        merges.extend(local)
    merges.sort(key=lambda val: val[2])
    return vocab, [[_token_bytes_to_string(l, table), _token_bytes_to_string(r, table)]
                   for l, r, _ in merges]


def load_tiktoken_ranks(vocab_file: str) -> dict[bytes, int]:
    """Parse a tiktoken rank file (``base64(token) rank`` per line)."""
    ranks = {}
    with open(vocab_file, "rb") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            token_b64, rank = line.split()
            ranks[base64.b64decode(token_b64)] = int(rank)
    return ranks


def _engine_config(vocab, merges, pattern, add_prefix_space, special_tokens):
    added = [{"id": idx, "content": tok, "special": True, "normalized": False,
              "lstrip": False, "rstrip": False, "single_word": False}
             for tok, idx in special_tokens.items()]
    full_vocab = dict(vocab)
    for tok, idx in special_tokens.items():
        full_vocab.setdefault(tok, idx)
    return {
        "version": "1.0",
        "added_tokens": added,
        "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": pattern},
             "behavior": "Isolated", "invert": False},
            {"type": "ByteLevel", "add_prefix_space": add_prefix_space,
             "use_regex": False},
        ]},
        "post_processor": {"type": "ByteLevel", "trim_offsets": False},
        "decoder": {"type": "ByteLevel"},
        "model": {"type": "BPE", "vocab": full_vocab,
                  "merges": merges, "ignore_merges": True,
                  "fuse_unk": False, "unk_token": None},
    }


def convert_tiktoken(vocab_file: str, pattern: str = GPT4_PATTERN,
                     add_prefix_space: bool = False,
                     extra_special_tokens=None) -> dict:
    """tiktoken rank file -> engine tokenizer.json dict."""
    ranks = load_tiktoken_ranks(vocab_file)
    vocab, merges = _ranks_to_vocab_merges(ranks)
    specials = {}
    base = max(vocab.values()) + 1 if vocab else 0
    for i, tok in enumerate(extra_special_tokens or []):
        specials[tok] = base + i
    return _engine_config(vocab, merges, pattern, add_prefix_space, specials)


def convert_tekken(tekken_file: str) -> dict:
    """Mistral ``tekken.json`` -> engine tokenizer.json dict."""
    with open(tekken_file, encoding="utf-8") as f:
        data = json.load(f)
    cfg = data["config"]
    pattern = cfg["pattern"]
    n_special = cfg.get("default_num_special_tokens", 1000)
    vocab_size = cfg.get("default_vocab_size")
    ranks = {}
    for entry in data["vocab"]:
        token = base64.b64decode(entry["token_bytes"])
        ranks[token] = entry["rank"]
    if vocab_size is not None:
        limit = vocab_size - n_special
        ranks = {t: r for t, r in ranks.items() if r < limit}
    vocab, merges = _ranks_to_vocab_merges(ranks)
    # regular ids sit after the reserved special block
    vocab = {tok: rank + n_special for tok, rank in vocab.items()}
    specials = {}
    for i, entry in enumerate(data.get("special_tokens", [])):
        if isinstance(entry, dict):
            specials[entry["token_str"]] = entry.get("rank", i)
        else:
            specials[entry] = i
    for i in range(len(specials), n_special):
        specials[f"<SPECIAL_{i}>"] = i
    return _engine_config(vocab, merges, pattern, False, specials)
