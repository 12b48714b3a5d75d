"""Fairseq / subword-nmt BPE tokenizer (BERTweet, PhoBERT); a copy of
``transformers_tpu/tokenization/fairseq_bpe.py``.

Reference models/bertweet/tokenization_bertweet.py and
models/phobert/tokenization_phobert.py: a fairseq dictionary ``vocab.txt``
(lines of ``token count``, ids offset by the 4 specials) plus ``bpe.codes``
merges; BPE runs per whitespace word with a ``</w>`` end marker and emits
``@@``-suffixed continuation pieces (:175-215). These checkpoints have no
tokenizer.json, so the slow algorithm IS the format.
"""

from __future__ import annotations

import os
import re


class FairseqBpeTokenizer:
    """Shared engine for the vocab.txt + bpe.codes families."""

    vocab_files = ("vocab.txt", "bpe.codes")

    def __init__(self, vocab_file, merges_file, bos_token="<s>", eos_token="</s>",
                 sep_token="</s>", cls_token="<s>", unk_token="<unk>",
                 pad_token="<pad>", mask_token="<mask>", **kwargs):
        self.bos_token, self.eos_token = bos_token, eos_token
        self.sep_token, self.cls_token = sep_token, cls_token
        self.unk_token, self.pad_token, self.mask_token = unk_token, pad_token, mask_token
        self.encoder = {bos_token: 0, pad_token: 1, eos_token: 2, unk_token: 3}
        self.add_from_file(vocab_file)
        self.encoder.setdefault(mask_token, len(self.encoder))
        self.decoder = {v: k for k, v in self.encoder.items()}
        with open(merges_file, encoding="utf-8") as f:
            merges = [tuple(line.rstrip("\n").split(" ")[:-1] or line.split())
                      for line in f if line.strip()]
        merges = [tuple(m[:2]) for m in merges]
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache: dict[str, str] = {}

    def add_from_file(self, path):
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                idx = line.rfind(" ")
                word = line[:idx] if idx != -1 else line
                self.encoder.setdefault(word, len(self.encoder))

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(list(token[:-1]) + [token[-1] + "</w>"])
        if len(word) == 1:
            return token
        while True:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            new_word = []
            i = 0
            while i < len(word):
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
        out = "@@ ".join(word)
        out = out[:-4]  # strip the trailing "</w>"
        self.cache[token] = out
        return out

    def tokenize(self, text: str) -> list[str]:
        pieces = []
        for tok in re.findall(r"\S+", text):
            pieces.extend(self.bpe(tok).split(" "))
        return pieces

    def convert_tokens_to_ids(self, tokens):
        unk = self.encoder[self.unk_token]
        return [self.encoder.get(t, unk) for t in tokens]

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        ids = self.convert_tokens_to_ids(self.tokenize(text))
        if add_special_tokens:
            return [self.encoder[self.cls_token]] + ids + [self.encoder[self.sep_token]]
        return ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        specials = {self.bos_token, self.eos_token, self.pad_token, self.cls_token,
                    self.sep_token, self.mask_token}
        toks = [self.decoder.get(int(i), self.unk_token) for i in ids]
        if skip_special_tokens:
            toks = [t for t in toks if t not in specials]
        return " ".join(toks).replace("@@ ", "").strip()

    @classmethod
    def from_pretrained(cls, path, **kwargs):
        vocab = os.path.join(str(path), cls.vocab_files[0])
        merges = os.path.join(str(path), cls.vocab_files[1])
        return cls(vocab, merges, **kwargs)
