"""tokenizer.json interpreter (port of ``transformers_tpu/tokenization/engine.py``).

It interprets the ``tokenizer.json`` schema of the reference's Rust
``tokenizers`` library: normalizers, pre-tokenizers, models (BPE /
WordPiece / Unigram / WordLevel), post-processors, decoders, and added-token
splitting. The JAX package compiles the schema's patterns with the ``regex``
module; here they run on stdlib ``re`` after ``unicode_classes.translate``,
which reproduces ``regex``'s ``\\p{L}``, ``\\p{N}``, ``\\p{P}``, ``\\s`` and
``\\w`` exactly or raises. A BPE model whose merge table maps into id space
(no subword prefix or suffix) merges in C++ (``native/csrc/bpe.cpp``); the
Python merge loop (``BPEModel.merge_plain``) is its plain version and the
route for the other tables.

Parity contract: the JAX engine's ids and decoded text on the same inputs
(tests/test_torch_tokenization.py).
"""

from __future__ import annotations

import functools
import json
import re
from typing import Any, Iterable, Optional

from . import unicode_classes

# --------------------------------------------------------------------------
# Byte-level alphabet (GPT-2's bytes_to_unicode)
# --------------------------------------------------------------------------


@functools.lru_cache(None)
def bytes_to_unicode() -> dict[int, str]:
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


@functools.lru_cache(None)
def unicode_to_bytes() -> dict[str, int]:
    return {v: k for k, v in bytes_to_unicode().items()}


# --------------------------------------------------------------------------
# Normalizers
# --------------------------------------------------------------------------


class Normalizer:
    @staticmethod
    def from_config(cfg: Optional[dict]) -> Optional["Normalizer"]:
        if cfg is None:
            return None
        t = cfg["type"]
        if t == "Sequence":
            return SequenceNormalizer([Normalizer.from_config(c) for c in cfg["normalizers"]])
        if t in ("NFC", "NFD", "NFKC", "NFKD"):
            return UnicodeNormalizer(t)
        if t == "Lowercase":
            return LowercaseNormalizer()
        if t == "Replace":
            return ReplaceNormalizer(cfg["pattern"], cfg["content"])
        if t == "Prepend":
            return PrependNormalizer(cfg["prepend"])
        if t == "Strip":
            return StripNormalizer(cfg.get("strip_left", cfg.get("left", True)), cfg.get("strip_right", cfg.get("right", True)))
        if t == "StripAccents":
            return StripAccentsNormalizer()
        if t == "BertNormalizer":
            return BertNormalizer(cfg)
        if t == "Precompiled":
            # spm precompiled charsmap — approximate with NFKC (documented gap)
            return UnicodeNormalizer("NFKC")
        raise NotImplementedError(f"normalizer {t}")

    def normalize(self, text: str) -> str:
        raise NotImplementedError


class SequenceNormalizer(Normalizer):
    def __init__(self, children):
        self.children = [c for c in children if c is not None]

    def normalize(self, text):
        for c in self.children:
            text = c.normalize(text)
        return text


class UnicodeNormalizer(Normalizer):
    def __init__(self, form):
        self.form = form

    def normalize(self, text):
        import unicodedata

        return unicodedata.normalize(self.form, text)


class LowercaseNormalizer(Normalizer):
    def normalize(self, text):
        return text.lower()


def _pattern_to_regex(pattern) -> "re.Pattern":
    if isinstance(pattern, dict):
        if "String" in pattern:
            return re.compile(re.escape(pattern["String"]))
        if "Regex" in pattern:
            return unicode_classes.compile(pattern["Regex"])
    return re.compile(re.escape(str(pattern)))


class ReplaceNormalizer(Normalizer):
    def __init__(self, pattern, content):
        self.pattern = _pattern_to_regex(pattern)
        self.content = content

    def normalize(self, text):
        return self.pattern.sub(self.content, text)


class PrependNormalizer(Normalizer):
    def __init__(self, prepend):
        self.prepend = prepend

    def normalize(self, text):
        return self.prepend + text if text else text


class StripNormalizer(Normalizer):
    def __init__(self, left, right):
        self.left, self.right = left, right

    def normalize(self, text):
        if self.left and self.right:
            return text.strip()
        if self.left:
            return text.lstrip()
        if self.right:
            return text.rstrip()
        return text


class StripAccentsNormalizer(Normalizer):
    def normalize(self, text):
        import unicodedata

        return "".join(c for c in unicodedata.normalize("NFD", text) if unicodedata.category(c) != "Mn")


class BertNormalizer(Normalizer):
    def __init__(self, cfg):
        self.clean_text = cfg.get("clean_text", True)
        self.handle_chinese_chars = cfg.get("handle_chinese_chars", True)
        self.strip_accents = cfg.get("strip_accents", None)
        self.lowercase = cfg.get("lowercase", True)

    @staticmethod
    def _is_chinese_char(cp: int) -> bool:
        return (
            0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
        )

    def normalize(self, text):
        import unicodedata

        if self.clean_text:
            out = []
            for ch in text:
                cp = ord(ch)
                if cp == 0 or cp == 0xFFFD or unicodedata.category(ch).startswith("C") and ch not in "\t\n\r":
                    continue
                out.append(" " if ch in "\t\n\r" or unicodedata.category(ch) == "Zs" else ch)
            text = "".join(out)
        if self.handle_chinese_chars:
            out = []
            for ch in text:
                if self._is_chinese_char(ord(ch)):
                    out.extend([" ", ch, " "])
                else:
                    out.append(ch)
            text = "".join(out)
        if self.lowercase:
            text = text.lower()
            if self.strip_accents is not False:
                text = StripAccentsNormalizer().normalize(text)
        elif self.strip_accents:
            text = StripAccentsNormalizer().normalize(text)
        return text


# --------------------------------------------------------------------------
# Pre-tokenizers — split normalized text into (pretoken, is_preserved) pieces
# --------------------------------------------------------------------------


class PreTokenizer:
    @staticmethod
    def from_config(cfg: Optional[dict]) -> Optional["PreTokenizer"]:
        if cfg is None:
            return None
        t = cfg["type"]
        if t == "Sequence":
            return SequencePreTokenizer([PreTokenizer.from_config(c) for c in cfg["pretokenizers"]])
        if t == "ByteLevel":
            return ByteLevelPreTokenizer(cfg.get("add_prefix_space", True), cfg.get("use_regex", True))
        if t == "Split":
            return SplitPreTokenizer(cfg["pattern"], cfg.get("behavior", "Removed"), cfg.get("invert", False))
        if t == "Metaspace":
            return MetaspacePreTokenizer(cfg.get("replacement", "▁"),
                                         cfg.get("prepend_scheme", "always" if cfg.get("add_prefix_space", True) else "never"),
                                         cfg.get("split", True))
        if t == "Whitespace":
            return SplitPreTokenizer({"Regex": r"\w+|[^\w\s]+"}, "Isolated", invert=True)
        if t == "WhitespaceSplit":
            return SplitPreTokenizer({"Regex": r"\s+"}, "Removed")
        if t == "BertPreTokenizer":
            return BertPreTokenizer()
        if t == "Digits":
            return DigitsPreTokenizer(cfg.get("individual_digits", False))
        if t == "Punctuation":
            return PunctuationPreTokenizer(cfg.get("behavior", "Isolated"))
        raise NotImplementedError(f"pre_tokenizer {t}")

    def pre_tokenize(self, text: str) -> list[str]:
        raise NotImplementedError


class SequencePreTokenizer(PreTokenizer):
    def __init__(self, children):
        self.children = [c for c in children if c is not None]

    def pre_tokenize(self, text):
        pieces = [text]
        for c in self.children:
            nxt = []
            for p in pieces:
                nxt.extend(c.pre_tokenize(p))
            pieces = nxt
        return pieces


GPT2_SPLIT = r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""


class ByteLevelPreTokenizer(PreTokenizer):
    """Maps bytes through the GPT-2 unicode alphabet after regex splitting."""

    def __init__(self, add_prefix_space=True, use_regex=True):
        self.add_prefix_space = add_prefix_space
        self.use_regex = use_regex
        self.pattern = unicode_classes.compile(GPT2_SPLIT) if use_regex else None
        self.byte_map = bytes_to_unicode()

    def _map(self, s: str) -> str:
        return "".join(self.byte_map[b] for b in s.encode("utf-8"))

    def pre_tokenize(self, text):
        if self.add_prefix_space and text and not text.startswith(" "):
            text = " " + text
        if self.use_regex:
            return [self._map(m.group()) for m in self.pattern.finditer(text)]
        return [self._map(text)] if text else []


class SplitPreTokenizer(PreTokenizer):
    def __init__(self, pattern, behavior="Removed", invert=False):
        self.regex = _pattern_to_regex(pattern)
        self.behavior = behavior
        self.invert = invert

    def pre_tokenize(self, text):
        if self.invert:
            return [m.group() for m in self.regex.finditer(text)]
        pieces: list[str] = []
        last = 0
        pending_merge = ""
        for m in self.regex.finditer(text):
            before = text[last : m.start()]
            match = m.group()
            if self.behavior == "Removed":
                if before:
                    pieces.append(before)
            elif self.behavior == "Isolated":
                if before:
                    pieces.append(before)
                if match:
                    pieces.append(match)
            elif self.behavior == "MergedWithPrevious":
                pieces.append(before + match)
            elif self.behavior == "MergedWithNext":
                if before:
                    pieces.append(pending_merge + before)
                    pending_merge = ""
                pending_merge += match
            elif self.behavior == "Contiguous":
                if before:
                    pieces.append(before)
                if match:
                    if pieces and last == m.start() and False:
                        pieces[-1] += match
                    else:
                        pieces.append(match)
            last = m.end()
        tail = text[last:]
        if self.behavior == "MergedWithNext":
            tail = pending_merge + tail
        if tail:
            pieces.append(tail)
        return [p for p in pieces if p]


class MetaspacePreTokenizer(PreTokenizer):
    def __init__(self, replacement="▁", prepend_scheme="always", split=True):
        self.replacement = replacement
        self.prepend_scheme = prepend_scheme  # always | never | first
        self.split = split

    def pre_tokenize(self, text, *, is_first_section=True):
        if self.prepend_scheme == "always" or (self.prepend_scheme == "first" and is_first_section):
            if not text.startswith(self.replacement) and not text.startswith(" "):
                text = " " + text
        text = text.replace(" ", self.replacement)
        if not self.split:
            return [text] if text else []
        # split on replacement, keeping it with the following token
        pieces = re.findall(re.escape(self.replacement) + r"[^" + re.escape(self.replacement) + r"]*|[^" + re.escape(self.replacement) + r"]+", text)
        return [p for p in pieces if p]


class BertPreTokenizer(PreTokenizer):
    # Rust is_punctuation: ASCII 33-47, 58-64, 91-96, 123-126 OR \p{P}.
    # Everything else (incl. emoji, CJK) groups into whitespace-split words.
    _punct = r"!-/:-@\[-`{-~"
    PATTERN = rf"[^\s{_punct}\p{{P}}]+|[{_punct}]|\p{{P}}"

    def __init__(self):
        self.pattern = unicode_classes.compile(self.PATTERN)

    def pre_tokenize(self, text):
        return self.pattern.findall(text)


class DigitsPreTokenizer(PreTokenizer):
    def __init__(self, individual_digits=False):
        self.individual = individual_digits
        self.split = SplitPreTokenizer({"Regex": r"\p{N}" if individual_digits else r"\p{N}+"},
                                       "Isolated")

    def pre_tokenize(self, text):
        return self.split.pre_tokenize(text)


class PunctuationPreTokenizer(PreTokenizer):
    def __init__(self, behavior="Isolated"):
        self.behavior = behavior
        self.split = SplitPreTokenizer({"Regex": r"\p{P}"}, behavior)

    def pre_tokenize(self, text):
        return self.split.pre_tokenize(text)


# --------------------------------------------------------------------------
# Models
# --------------------------------------------------------------------------


class TokenModel:
    unk_token: Optional[str] = None

    @staticmethod
    def from_config(cfg: dict, native_bpe: bool = True) -> "TokenModel":
        t = cfg.get("type", "BPE")
        if t == "BPE":
            return BPEModel(cfg, native=native_bpe)
        if t == "WordPiece":
            return WordPieceModel(cfg)
        if t == "Unigram":
            return UnigramModel(cfg)
        if t == "WordLevel":
            return WordLevelModel(cfg)
        raise NotImplementedError(f"model {t}")

    def tokenize_word(self, word: str) -> list[str]:
        raise NotImplementedError

    @property
    def vocab(self) -> dict[str, int]:
        raise NotImplementedError


class BPEModel(TokenModel):
    """``native``: merge in C++ where the table maps into id space (False: the
    Python merge loop, the C++ route's plain version, for every word)."""

    def __init__(self, cfg: dict, native: bool = True):
        self._vocab: dict[str, int] = cfg["vocab"]
        merges = cfg.get("merges", [])
        self.merge_ranks: dict[tuple[str, str], int] = {}
        for i, m in enumerate(merges):
            pair = tuple(m) if isinstance(m, (list, tuple)) else tuple(m.split(" ", 1))
            self.merge_ranks[pair] = i
        self.unk_token = cfg.get("unk_token")
        self.continuing_subword_prefix = cfg.get("continuing_subword_prefix") or ""
        self.end_of_word_suffix = cfg.get("end_of_word_suffix") or ""
        self.byte_fallback = cfg.get("byte_fallback", False)
        self.ignore_merges = cfg.get("ignore_merges", False)
        self.fuse_unk = cfg.get("fuse_unk", False)
        self._cache: dict[str, list[str]] = {}
        self._native = None
        self._native_tried = not native
        self._id_to_token: dict[int, str] = {}

    def _try_native(self):
        """Build the C++ merge engine (native/csrc/bpe.cpp) when the merge
        table maps cleanly to id space (no subword prefix/suffix rewriting).
        A failed build raises: there is no quiet fall back to Python."""
        if self.continuing_subword_prefix or self.end_of_word_suffix or not self.merge_ranks:
            self._native_tried = True
            return
        merges = []
        ordered = sorted(self.merge_ranks.items(), key=lambda kv: kv[1])
        for (l, r), _rank in ordered:
            li, ri, mi = self._vocab.get(l), self._vocab.get(r), self._vocab.get(l + r)
            if li is None or ri is None or mi is None:
                self._native_tried = True
                return  # unmappable merge table; stay on the Python path
            merges.append((li, ri, mi))
        from ..native import NativeBPE

        self._native = NativeBPE(merges)  # a failed build raises here, at every call
        self._id_to_token = {v: k for k, v in self._vocab.items()}
        self._native_tried = True

    @property
    def uses_native(self) -> bool:
        """Whether words merge in C++ (known once the first word was tokenized)."""
        return self._native is not None

    @property
    def vocab(self):
        return self._vocab

    def tokenize_word(self, word: str) -> list[str]:
        if self.ignore_merges and word in self._vocab:
            return [word]
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        if not self._native_tried:
            self._try_native()
        out = None
        if self._native is not None:
            ids = [self._vocab.get(c) for c in word]
            if all(i is not None for i in ids):
                out = [self._id_to_token[i] for i in self._native.encode(ids)]
        if out is None:
            out = self.merge_plain(word)
        if len(self._cache) < 65536:
            self._cache[word] = out
        return out

    def merge_plain(self, word: str) -> list[str]:
        """The Python merge loop: the lowest-ranked adjacent pair merges first."""
        parts = list(word)
        if self.end_of_word_suffix and parts:
            parts[-1] = parts[-1] + self.end_of_word_suffix
        if self.continuing_subword_prefix:
            parts = [parts[0]] + [self.continuing_subword_prefix + p for p in parts[1:]]
        while len(parts) > 1:
            best_rank = None
            best_i = -1
            for i in range(len(parts) - 1):
                r = self.merge_ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            merged = parts[best_i] + (
                parts[best_i + 1][len(self.continuing_subword_prefix):]
                if self.continuing_subword_prefix else parts[best_i + 1]
            )
            parts = parts[:best_i] + [merged] + parts[best_i + 2 :]
        out: list[str] = []
        for p in parts:
            if p in self._vocab:
                out.append(p)
            elif self.byte_fallback:
                for b in p.encode("utf-8"):
                    out.append(f"<0x{b:02X}>")
            elif self.unk_token is not None:
                if self.fuse_unk and out and out[-1] == self.unk_token:
                    continue
                out.append(self.unk_token)
        return out


class WordPieceModel(TokenModel):
    def __init__(self, cfg: dict):
        self._vocab = cfg["vocab"]
        self.unk_token = cfg.get("unk_token", "[UNK]")
        self.prefix = cfg.get("continuing_subword_prefix", "##")
        self.max_input_chars = cfg.get("max_input_chars_per_word", 100)

    @property
    def vocab(self):
        return self._vocab

    def tokenize_word(self, word: str) -> list[str]:
        if len(word) > self.max_input_chars:
            return [self.unk_token]
        tokens = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = self.prefix + sub
                if sub in self._vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            tokens.append(cur)
            start = end
        return tokens


class UnigramModel(TokenModel):
    """Viterbi segmentation over (token, logprob) vocab."""

    def __init__(self, cfg: dict):
        entries = cfg["vocab"]  # list of [token, logprob]
        self.pieces = {tok: float(lp) for tok, lp in entries}
        self._vocab = {tok: i for i, (tok, _) in enumerate(entries)}
        unk_id = cfg.get("unk_id")
        self.unk_token = entries[unk_id][0] if unk_id is not None else None
        self.byte_fallback = cfg.get("byte_fallback", False)
        self.max_piece_len = max((len(t) for t in self.pieces), default=1)
        self.min_score = min(self.pieces.values(), default=0.0)

    @property
    def vocab(self):
        return self._vocab

    def tokenize_word(self, word: str) -> list[str]:
        n = len(word)
        if n == 0:
            return []
        # Viterbi: best[i] = (score, backpointer)
        NEG = -1e18
        best = [NEG] * (n + 1)
        back = [0] * (n + 1)
        unk_penalty = self.min_score - 10.0
        best[0] = 0.0
        for i in range(1, n + 1):
            lo = max(0, i - self.max_piece_len)
            for j in range(lo, i):
                if best[j] <= NEG / 2:
                    continue
                piece = word[j:i]
                lp = self.pieces.get(piece)
                if lp is None:
                    if i - j == 1:
                        lp = unk_penalty  # single-char unk fallback
                    else:
                        continue
                score = best[j] + lp
                if score > best[i]:
                    best[i] = score
                    back[i] = j
        # reconstruct
        out = []
        i = n
        while i > 0:
            j = back[i]
            out.append(word[j:i])
            i = j
        out.reverse()
        final = []
        for p in out:
            if p in self.pieces:
                final.append(p)
            elif self.byte_fallback:
                final.extend(f"<0x{b:02X}>" for b in p.encode("utf-8"))
            elif self.unk_token:
                final.append(self.unk_token)
        return final


class WordLevelModel(TokenModel):
    def __init__(self, cfg: dict):
        self._vocab = cfg["vocab"]
        self.unk_token = cfg.get("unk_token", "<unk>")

    @property
    def vocab(self):
        return self._vocab

    def tokenize_word(self, word: str) -> list[str]:
        return [word if word in self._vocab else self.unk_token]


# --------------------------------------------------------------------------
# Post-processors
# --------------------------------------------------------------------------


class PostProcessor:
    @staticmethod
    def from_config(cfg: Optional[dict]) -> Optional["PostProcessor"]:
        if cfg is None:
            return None
        t = cfg["type"]
        if t == "TemplateProcessing":
            return TemplateProcessor(cfg)
        if t == "ByteLevel":
            return None  # byte-level post-processor only affects offsets
        if t == "RobertaProcessing":
            return PairProcessor(
                single=[("special", cfg["cls"][0]), ("seq", "A"), ("special", cfg["sep"][0])],
                pair=[("special", cfg["cls"][0]), ("seq", "A"), ("special", cfg["sep"][0]),
                      ("special", cfg["sep"][0]), ("seq", "B"), ("special", cfg["sep"][0])],
                ids={cfg["cls"][0]: cfg["cls"][1], cfg["sep"][0]: cfg["sep"][1]},
            )
        if t == "BertProcessing":
            return PairProcessor(
                single=[("special", cfg["cls"][0]), ("seq", "A"), ("special", cfg["sep"][0])],
                pair=[("special", cfg["cls"][0]), ("seq", "A"), ("special", cfg["sep"][0]),
                      ("seq", "B"), ("special", cfg["sep"][0])],
                ids={cfg["cls"][0]: cfg["cls"][1], cfg["sep"][0]: cfg["sep"][1]},
                pair_type_ids=True,
            )
        if t == "Sequence":
            procs = [PostProcessor.from_config(c) for c in cfg["processors"]]
            procs = [p for p in procs if p is not None]
            if not procs:
                return None
            if len(procs) == 1:
                return procs[0]
            return SequencePostProcessor(procs)
        raise NotImplementedError(f"post_processor {t}")

    def process(self, ids_a: list[int], ids_b: Optional[list[int]], add_special_tokens: bool) -> tuple[list[int], list[int], list[int]]:
        """returns (ids, type_ids, special_tokens_mask)"""
        raise NotImplementedError


class TemplateProcessor(PostProcessor):
    def __init__(self, cfg):
        self.single = cfg["single"]
        self.pair = cfg.get("pair")
        self.special_tokens = {k: v for k, v in cfg.get("special_tokens", {}).items()}

    def _render(self, template, ids_a, ids_b, add_special_tokens):
        ids, type_ids, special = [], [], []
        for item in template:
            if "SpecialToken" in item:
                if not add_special_tokens:
                    continue
                st = item["SpecialToken"]
                tok_ids = self.special_tokens[st["id"]]["ids"]
                ids.extend(tok_ids)
                type_ids.extend([st["type_id"]] * len(tok_ids))
                special.extend([1] * len(tok_ids))
            elif "Sequence" in item:
                seq = item["Sequence"]
                src = ids_a if seq["id"] == "A" else ids_b
                ids.extend(src)
                type_ids.extend([seq["type_id"]] * len(src))
                special.extend([0] * len(src))
        return ids, type_ids, special

    def process(self, ids_a, ids_b, add_special_tokens):
        if ids_b is None:
            return self._render(self.single, ids_a, None, add_special_tokens)
        if self.pair is None:
            a = self._render(self.single, ids_a, None, add_special_tokens)
            b = self._render(self.single, ids_b, None, add_special_tokens)
            return a[0] + b[0], a[1] + [1] * len(b[1]), a[2] + b[2]
        return self._render(self.pair, ids_a, ids_b, add_special_tokens)


class PairProcessor(PostProcessor):
    def __init__(self, single, pair, ids, pair_type_ids=False):
        self.single, self.pair, self.ids = single, pair, ids
        self.pair_type_ids = pair_type_ids

    def process(self, ids_a, ids_b, add_special_tokens):
        template = self.single if ids_b is None else self.pair
        ids, type_ids, special = [], [], []
        seen_b = False
        for kind, val in template:
            if kind == "special":
                if not add_special_tokens:
                    continue
                ids.append(self.ids[val])
                type_ids.append(1 if (seen_b and self.pair_type_ids) else 0)
                special.append(1)
            else:
                src = ids_a if val == "A" else ids_b
                if val == "B":
                    seen_b = True
                ids.extend(src)
                type_ids.extend([1 if (val == "B" and self.pair_type_ids) else 0] * len(src))
                special.extend([0] * len(src))
        return ids, type_ids, special


class SequencePostProcessor(PostProcessor):
    def __init__(self, procs):
        self.procs = procs

    def process(self, ids_a, ids_b, add_special_tokens):
        # Compose: in practice sequences are [ByteLevel, Template]; ByteLevel
        # returns None above, so this handles the general chain conservatively
        # by applying the last processor.
        return self.procs[-1].process(ids_a, ids_b, add_special_tokens)


# --------------------------------------------------------------------------
# Decoders
# --------------------------------------------------------------------------


class TokenDecoder:
    @staticmethod
    def from_config(cfg: Optional[dict]) -> Optional["TokenDecoder"]:
        if cfg is None:
            return None
        t = cfg["type"]
        if t == "ByteLevel":
            return ByteLevelDecoder()
        if t == "Metaspace":
            return MetaspaceDecoder(cfg.get("replacement", "▁"),
                                    cfg.get("prepend_scheme", "always"))
        if t == "WordPiece":
            return WordPieceDecoder(cfg.get("prefix", "##"), cfg.get("cleanup", True))
        if t == "ByteFallback":
            return ByteFallbackDecoder()
        if t == "Replace":
            return ReplaceDecoder(cfg["pattern"], cfg["content"])
        if t == "Fuse":
            return FuseDecoder()
        if t == "Strip":
            return StripDecoder(cfg.get("content", " "), cfg.get("start", 0), cfg.get("stop", 0))
        if t == "Sequence":
            return SequenceDecoder([TokenDecoder.from_config(c) for c in cfg["decoders"]])
        if t == "BPEDecoder":
            return BPESuffixDecoder(cfg.get("suffix", "</w>"))
        if t == "CTC":
            return CTCDecoder(cfg)
        raise NotImplementedError(f"decoder {t}")

    def decode_chain(self, tokens: list[str]) -> list[str]:
        raise NotImplementedError


class ByteLevelDecoder(TokenDecoder):
    def decode_chain(self, tokens):
        # UTF-8 sequences may span token boundaries, so the whole run must be
        # mapped to bytes BEFORE decoding (matches the Rust ByteLevel decoder;
        # per-token decoding would mangle multi-byte characters).
        u2b = unicode_to_bytes()
        bs = bytes(u2b[c] for tok in tokens for c in tok if c in u2b)
        return [bs.decode("utf-8", errors="replace")]


class MetaspaceDecoder(TokenDecoder):
    def __init__(self, replacement="▁", prepend_scheme="always"):
        self.replacement = replacement
        self.prepend_scheme = prepend_scheme

    def decode_chain(self, tokens):
        out = []
        for i, tok in enumerate(tokens):
            s = tok.replace(self.replacement, " ")
            if i == 0 and self.prepend_scheme != "never" and s.startswith(" "):
                s = s[1:]
            out.append(s)
        return out


class WordPieceDecoder(TokenDecoder):
    def __init__(self, prefix="##", cleanup=True):
        self.prefix = prefix
        self.cleanup = cleanup

    def decode_chain(self, tokens):
        out = []
        for i, tok in enumerate(tokens):
            if i != 0:
                if tok.startswith(self.prefix):
                    tok = tok[len(self.prefix):]
                else:
                    tok = " " + tok
            if self.cleanup:
                for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
                             (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"), (" 're", "'re")):
                    tok = tok.replace(a, b)
            out.append(tok)
        return out


class ByteFallbackDecoder(TokenDecoder):
    pat = re.compile(r"^<0x([0-9A-Fa-f]{2})>$")

    def decode_chain(self, tokens):
        out = []
        buf: list[int] = []

        def flush():
            if buf:
                out.append(bytes(buf).decode("utf-8", errors="replace"))
                buf.clear()

        for tok in tokens:
            m = self.pat.match(tok)
            if m:
                buf.append(int(m.group(1), 16))
            else:
                flush()
                out.append(tok)
        flush()
        return out


class ReplaceDecoder(TokenDecoder):
    def __init__(self, pattern, content):
        self.pattern = _pattern_to_regex(pattern)
        self.content = content

    def decode_chain(self, tokens):
        return [self.pattern.sub(self.content, t) for t in tokens]


class FuseDecoder(TokenDecoder):
    def decode_chain(self, tokens):
        return ["".join(tokens)]


class StripDecoder(TokenDecoder):
    def __init__(self, content=" ", start=0, stop=0):
        self.content, self.start, self.stop = content, start, stop

    def decode_chain(self, tokens):
        out = []
        for tok in tokens:
            s = tok
            n = 0
            while n < self.start and s.startswith(self.content):
                s = s[len(self.content):]
                n += 1
            n = 0
            while n < self.stop and s.endswith(self.content):
                s = s[: -len(self.content)]
                n += 1
            out.append(s)
        return out


class SequenceDecoder(TokenDecoder):
    def __init__(self, children):
        self.children = [c for c in children if c is not None]

    def decode_chain(self, tokens):
        for c in self.children:
            tokens = c.decode_chain(tokens)
        return tokens


class BPESuffixDecoder(TokenDecoder):
    def __init__(self, suffix="</w>"):
        self.suffix = suffix

    def decode_chain(self, tokens):
        return [t.replace(self.suffix, " ") for t in tokens]


class CTCDecoder(TokenDecoder):
    def __init__(self, cfg):
        self.pad_token = cfg.get("pad_token", "<pad>")
        self.word_delimiter = cfg.get("word_delimiter_token", "|")
        self.cleanup = cfg.get("cleanup", True)

    def decode_chain(self, tokens):
        # collapse repeats, drop pad, map delimiter to space
        out = []
        prev = None
        for t in tokens:
            if t == prev:
                continue
            prev = t
            if t == self.pad_token:
                continue
            out.append(" " if t == self.word_delimiter else t)
        return out


# --------------------------------------------------------------------------
# Added tokens + the full engine
# --------------------------------------------------------------------------


class AddedToken:
    def __init__(self, cfg: dict):
        self.id = cfg["id"]
        self.content = cfg["content"]
        self.single_word = cfg.get("single_word", False)
        self.lstrip = cfg.get("lstrip", False)
        self.rstrip = cfg.get("rstrip", False)
        self.normalized = cfg.get("normalized", False)
        self.special = cfg.get("special", False)


class TokenizerEngine:
    """Interpreter for one tokenizer.json. ``native_bpe=False`` runs a BPE
    model's merges through the Python loop only (the plain version)."""

    def __init__(self, config: dict, native_bpe: bool = True):
        self.config = config
        self.normalizer = Normalizer.from_config(config.get("normalizer"))
        self.pre_tokenizer = PreTokenizer.from_config(config.get("pre_tokenizer"))
        self.model = TokenModel.from_config(config["model"], native_bpe)
        self.post_processor = PostProcessor.from_config(config.get("post_processor"))
        self.decoder = TokenDecoder.from_config(config.get("decoder"))
        self.added_tokens = [AddedToken(t) for t in config.get("added_tokens", [])]

        self.vocab: dict[str, int] = dict(self.model.vocab)
        for t in self.added_tokens:
            self.vocab.setdefault(t.content, t.id)
        self.id_to_token: dict[int, str] = {v: k for k, v in self.vocab.items()}
        self.added_by_content = {t.content: t for t in self.added_tokens}
        self.special_ids = {t.id for t in self.added_tokens if t.special}
        # split pattern: longest first
        if self.added_tokens:
            alts = sorted((t.content for t in self.added_tokens), key=len, reverse=True)
            self._added_re = re.compile("(" + "|".join(re.escape(a) for a in alts) + ")")
        else:
            self._added_re = None

    @classmethod
    def from_file(cls, path: str, **kwargs) -> "TokenizerEngine":
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f), **kwargs)

    @classmethod
    def from_str(cls, s: str, **kwargs) -> "TokenizerEngine":
        return cls(json.loads(s), **kwargs)

    # ---------------------------------------------------------------- encode
    def _encode_section(self, text: str, is_first: bool) -> list[int]:
        if not text:
            return []
        if self.normalizer is not None:
            text = self.normalizer.normalize(text)
        if self.pre_tokenizer is not None:
            if isinstance(self.pre_tokenizer, MetaspacePreTokenizer):
                words = self.pre_tokenizer.pre_tokenize(text, is_first_section=is_first)
            else:
                words = self.pre_tokenizer.pre_tokenize(text)
        else:
            words = [text]
        ids: list[int] = []
        get = self.vocab.get
        unk = self.model.unk_token
        for w in words:
            for tok in self.model.tokenize_word(w):
                i = get(tok)
                if i is None and unk is not None:
                    i = get(unk)
                if i is not None:
                    ids.append(i)
        return ids

    def encode_no_special(self, text: str) -> list[int]:
        """Tokenize without the post-processor template (raw sequence ids)."""
        if self._added_re is None:
            return self._encode_section(text, True)
        ids: list[int] = []
        first = True
        parts = self._added_re.split(text)
        for part in parts:
            if not part:
                continue
            added = self.added_by_content.get(part)
            if added is not None:
                ids.append(added.id)
                first = False
            else:
                ids.extend(self._encode_section(part, first))
                first = False
        return ids

    def encode(self, text: str, pair: Optional[str] = None, add_special_tokens: bool = True) -> dict:
        ids_a = self.encode_no_special(text)
        ids_b = self.encode_no_special(pair) if pair is not None else None
        if self.post_processor is not None:
            ids, type_ids, special_mask = self.post_processor.process(ids_a, ids_b, add_special_tokens)
        else:
            ids = ids_a + (ids_b or [])
            type_ids = [0] * len(ids_a) + [1] * len(ids_b or [])
            special_mask = [0] * len(ids)
        return {"input_ids": ids, "token_type_ids": type_ids, "special_tokens_mask": special_mask}

    # ---------------------------------------------------------------- decode
    def convert_ids_to_tokens(self, ids: Iterable[int]) -> list[str]:
        return [self.id_to_token.get(int(i), "") for i in ids]

    def decode(self, ids: Iterable[int], skip_special_tokens: bool = False) -> str:
        toks: list[str] = []
        for i in ids:
            i = int(i)
            if skip_special_tokens and i in self.special_ids:
                continue
            t = self.id_to_token.get(i)
            if t is not None:
                toks.append(t)
        if self.decoder is not None:
            # added tokens pass through the decoder chain unscathed in the Rust
            # impl; approximate by decoding contiguous non-added runs.
            out_parts: list[str] = []
            run: list[str] = []
            for t in toks:
                if t in self.added_by_content:
                    if run:
                        out_parts.extend(self.decoder.decode_chain(run))
                        run = []
                    out_parts.append(t)
                else:
                    run.append(t)
            if run:
                out_parts.extend(self.decoder.decode_chain(run))
            return "".join(out_parts)
        return " ".join(toks)
