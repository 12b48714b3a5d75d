"""The port's tokenizer (``transformers_tpu_torch.tokenization``) against the
JAX package's on the same inputs: ids, tokens and decoded text.

The JAX engine compiles tokenizer.json patterns with the ``regex`` module;
the port runs them on stdlib ``re`` through ``unicode_classes``, whose tables
are held here to ``regex``'s classes over every code point, and whose
translator must raise on what it cannot make exact. The texts carry what
tells the two apart: U+001C-U+001F (stdlib ``\\s`` matches them,
``regex``'s does not), letters and digits newer than Python's
``unicodedata`` (U+0C5C, U+1C89, U+10D40), the long s and the Kelvin sign in
case-insensitive contractions, CJK, emoji and combining marks, and added
tokens inside text. The configs: the repo's 48k-entry Llama-3-style fixture,
and byte-level BPE (GPT-2 split, added tokens), WordPiece/BERT (``\\p{P}``),
digits and whitespace splits (``\\p{N}``, ``\\w``), Unigram/Metaspace,
Llama-3 style and byte-fallback BPE, built with the Rust ``tokenizers``
library as tests/tokenization/test_engine_parity.py builds them; here the
JAX package is the oracle.
"""

import json
import shutil
import struct
from pathlib import Path

import numpy as np
import pytest
import regex
import torch

import transformers_tpu.tokenization as jax_tok
from transformers_tpu.tokenization.engine import TokenizerEngine as JaxEngine
from transformers_tpu.tokenization.engine import bytes_to_unicode

import transformers_tpu_torch as port
from transformers_tpu_torch import native
from transformers_tpu_torch.tokenization import unicode_classes
from transformers_tpu_torch.tokenization.engine import GPT2_SPLIT, TokenizerEngine
from transformers_tpu_torch.tokenization.tiktoken_convert import GPT4_PATTERN
from torch_port_testing import one_torch_thread  # noqa: F401

tokenizers = pytest.importorskip("tokenizers")

FIXTURE_DIR = Path(__file__).resolve().parent / "fixtures" / "bpe48k"
ALL_CODE_POINTS = "".join(chr(c) for c in range(unicode_classes.MAX_CODE_POINT + 1))

CORPUS = [
    "Hello world! The quick brown fox jumps over the lazy dog.",
    "def forward(self, input_ids, attention_mask=None):\n    return self.embed(input_ids)",
    "  leading spaces,   multiple   spaces, trailing  ",
    "\t\ttabs\tand\nnewlines\r\nwindows line endings\r\n",
    "numbers 1 23 456 7890 123456 3.14159 0xDEADBEEF 1e-5",
    "don't can't won't it's we're I'll they've I'm he'd DON'T CAN'T",
    "!!!???...;;;:::()[]{}<>@#$%^&*~`|\\/\"'",
    "field\x1crecord\x1dgroup\x1eunit\x1f sep \x1c\x1c end",
    "no-break\u00a0space, next\u0085line, ideographic\u3000space, \u2028\u2029",
    "\u017f's \u212a's \u017f'S IT'\u017f 'll 'LL \u212a'd",
    "letters only regex knows: \u0c5c\u1c89 a\u088fb and digits \U00010d40\U00010d41 9",
    "CJK \u4e2d\u6587\u5206\u8bcd \u543e\u8f29\u306f\u732b\u3067\u3042\u308b\u3002",
    "emoji \U0001f917\U0001f680 \U0001f469\u200d\U0001f469\u200d\U0001f467 combining e\u0301 "
    "a\u0308o\u0328 \u0915\u093f \u0627\u0644\u0639\u0631\u0628\u064a\u0629 \u0395\u03bb",
    "inline <|eot_id|> special <|start_header_id|>user<|end_header_id|> tokens",
    "<|begin_of_text|>system<|end_of_text|> not-a-special <|fake_token|>",
    "a",
    " ",
    "",
]

PROBE_PATTERNS = {  # the patterns the engines compile, held over every code point
    "llama3_split": GPT4_PATTERN,
    "gpt2_split": GPT2_SPLIT,
    "bert_punctuation": r"[^\s!-/:-@\[-`{-~\p{P}]+|[!-/:-@\[-`{-~]|\p{P}",
    "whitespace": r"\w+|[^\w\s]+",
}

UNTRANSLATABLE = [
    r"\d+", r"\bword\b", r"\p{Lu}", r"\p{Han}", r"(?i:[a-z]+)", r"(?i:it)", r"(?i)\p{L}",
    r"(?i:\u00e9)", r"[[a-z]]", r"[a--b]", r"[a&&b]", r"a(?i)b", r"(?x) a", r"\X",
    r"(?|a|b)", r"\x{41}", r"\N{DIGIT ONE}", r"(?P=name)", r"a)", r"(a", r"[ab", r"\K",
    r"\G", r"\R", r"\h", "x\\",
]


@pytest.fixture(scope="module")
def fixture_pair():
    path = str(FIXTURE_DIR / "tokenizer.json")
    return JaxEngine.from_file(path), TokenizerEngine.from_file(path)


@pytest.fixture(scope="module")
def long_document():
    return (Path(__file__).resolve().parents[1] / "transformers_tpu" / "modeling_utils.py"
            ).read_text()[:20000]


def _hold(jax_engine, engine, texts):
    for text in texts:
        want = jax_engine.encode(text)
        got = engine.encode(text)
        assert got["input_ids"] == want["input_ids"], text
        assert got["token_type_ids"] == want["token_type_ids"], text
        ids = want["input_ids"]
        assert engine.convert_ids_to_tokens(ids) == jax_engine.convert_ids_to_tokens(ids), text
        for skip in (False, True):
            assert engine.decode(ids, skip) == jax_engine.decode(ids, skip), text


def test_fixture_ids_tokens_and_text_match_jax(fixture_pair, long_document):
    jax_engine, engine = fixture_pair
    _hold(jax_engine, engine, CORPUS + [long_document])
    assert engine.model.uses_native
    # ids past the vocabulary decode to nothing, as in JAX
    ids = engine.encode(CORPUS[13])["input_ids"] + [47_999, 48_005, 48_006, 128_255]
    for skip in (False, True):
        assert engine.decode(ids, skip) == jax_engine.decode(ids, skip)


def test_cpp_bpe_equals_python_merge(fixture_pair, long_document):
    _, engine = fixture_pair
    model = engine.model
    words = {w for text in CORPUS + [long_document]
             for w in engine.pre_tokenizer.pre_tokenize(text)}
    model._cache.clear()
    for w in sorted(words):
        assert model.tokenize_word(w) == model.merge_plain(w), w
    assert model.uses_native and len(words) > 900
    plain = TokenizerEngine(engine.config, native_bpe=False)
    assert plain.encode(long_document) == engine.encode(long_document)
    assert not plain.model.uses_native


def _trained_configs() -> dict:
    """tokenizer.json strings built with the Rust library, as
    tests/tokenization/test_engine_parity.py builds them, plus digit,
    punctuation and whitespace splits over the WordPiece vocabulary."""
    from tokenizers import (Tokenizer, decoders, models, normalizers, pre_tokenizers,
                            processors, trainers)

    train = [t for t in CORPUS if t] * 20 + ["repetition builds merges 12 345"] * 50
    out = {}

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.post_processor = processors.ByteLevel(trim_offsets=False)
    tok.train_from_iterator(train, trainers.BpeTrainer(vocab_size=400,
                                                       special_tokens=["<|endoftext|>"]))
    tok.add_special_tokens(["<|user|>"])
    tok.add_tokens(["<plain_added>"])
    out["byte_level_added_tokens"] = tok.to_str()
    llama3 = json.loads(tok.to_str())
    llama3["model"]["ignore_merges"] = True
    llama3["pre_tokenizer"] = {"type": "Sequence", "pretokenizers": [
        {"type": "Split", "pattern": {"Regex": GPT4_PATTERN}, "behavior": "Isolated",
         "invert": False},
        {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
         "use_regex": False}]}
    out["llama3_style"] = json.dumps(llama3)

    tok = Tokenizer(models.WordPiece(unk_token="[UNK]"))
    tok.normalizer = normalizers.BertNormalizer()
    tok.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
    tok.decoder = decoders.WordPiece()
    tok.train_from_iterator(train, trainers.WordPieceTrainer(
        vocab_size=400, special_tokens=["[PAD]", "[UNK]", "[CLS]", "[SEP]"]))
    tok.post_processor = processors.TemplateProcessing(
        single="[CLS] $A [SEP]", pair="[CLS] $A [SEP] $B:1 [SEP]:1",
        special_tokens=[("[CLS]", tok.token_to_id("[CLS]")), ("[SEP]", tok.token_to_id("[SEP]"))])
    out["wordpiece_bert"] = tok.to_str()
    for name, pre in (("digits_whitespace", [{"type": "Whitespace"},
                                             {"type": "Digits", "individual_digits": True}]),
                      ("punctuation_split", [{"type": "WhitespaceSplit"},
                                             {"type": "Punctuation", "behavior": "Isolated"},
                                             {"type": "Digits", "individual_digits": False}])):
        cfg = json.loads(out["wordpiece_bert"])
        cfg["pre_tokenizer"] = {"type": "Sequence", "pretokenizers": pre}
        out[name] = json.dumps(cfg)

    tok = Tokenizer(models.Unigram())
    tok.pre_tokenizer = pre_tokenizers.Metaspace()
    tok.decoder = decoders.Metaspace()
    tok.train_from_iterator(train, trainers.UnigramTrainer(vocab_size=300,
                                                           special_tokens=["<unk>"],
                                                           unk_token="<unk>"))
    out["unigram_metaspace"] = tok.to_str()

    tok = Tokenizer(models.BPE(unk_token=None, byte_fallback=True))
    tok.normalizer = normalizers.Sequence([normalizers.Prepend("▁"),
                                           normalizers.Replace(" ", "▁")])
    tok.decoder = decoders.Sequence([decoders.Replace("▁", " "), decoders.ByteFallback(),
                                     decoders.Fuse(), decoders.Strip(" ", 1, 0)])
    tok.train_from_iterator([c.replace(" ", "▁") for c in train], trainers.BpeTrainer(
        vocab_size=400, special_tokens=["<unk>", "<s>", "</s>"],
        initial_alphabet=[f"<0x{b:02X}>" for b in range(256)]))
    out["byte_fallback"] = tok.to_str()
    return out


@pytest.fixture(scope="module")
def trained_configs():
    return _trained_configs()


@pytest.mark.parametrize("name", ["byte_level_added_tokens", "llama3_style", "wordpiece_bert",
                                  "digits_whitespace", "punctuation_split", "unigram_metaspace",
                                  "byte_fallback"])
def test_config_matches_jax(trained_configs, name):
    cfg = trained_configs[name]
    texts = CORPUS + ["<|user|>Hello<|endoftext|> x<plain_added>y"]
    _hold(JaxEngine.from_str(cfg), TokenizerEngine.from_str(cfg), texts)
    pair = ("first sentence \x1c 12", "second \u0c5c one")
    assert (TokenizerEngine.from_str(cfg).encode(*pair)
            == JaxEngine.from_str(cfg).encode(*pair))


@pytest.mark.parametrize("name", list(unicode_classes.SOURCES))
def test_table_equals_regex_class(name):
    want = [(m.start(), m.end() - 1) for m in
            regex.finditer(f"(?:{unicode_classes.SOURCES[name]})+", ALL_CODE_POINTS)]
    assert list(unicode_classes.ranges(name)) == want


@pytest.mark.parametrize("name", list(PROBE_PATTERNS))
def test_translated_pattern_matches_regex_everywhere(name):
    pattern = PROBE_PATTERNS[name]
    spans = [m.span() for m in unicode_classes.compile(pattern).finditer(ALL_CODE_POINTS)]
    assert spans == [m.span() for m in regex.finditer(pattern, ALL_CODE_POINTS)]


def test_case_insensitive_ascii_literals_agree():
    """What the translator lets through under (?i): each ASCII character but
    i/I case-matches the same code points in both libraries."""
    import re

    chars = "".join(chr(c) for c in range(128) if chr(c) not in "iI")
    union = "(?i)[" + re.escape(chars) + "]"
    hits = [m.start() for m in re.finditer(union, ALL_CODE_POINTS)]
    assert hits == [m.start() for m in regex.finditer(union, ALL_CODE_POINTS)]
    for c in chars:
        lit = "(?i:" + re.escape(c) + ")"
        assert unicode_classes.translate(lit) == lit
        for cp in hits:
            assert bool(re.fullmatch(lit, chr(cp))) == bool(regex.fullmatch(lit, chr(cp))), (c, cp)
    assert len(hits) > 2 * 26  # the long s and the Kelvin sign among them


@pytest.mark.parametrize("pattern", UNTRANSLATABLE)
def test_untranslatable_pattern_raises(pattern):
    with pytest.raises(unicode_classes.UntranslatablePattern):
        unicode_classes.translate(pattern)


@pytest.fixture(scope="module")
def chat_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tok_chat")
    shutil.copy(FIXTURE_DIR / "tokenizer.json", d / "tokenizer.json")
    (d / "tokenizer_config.json").write_text(json.dumps({
        "bos_token": "<|begin_of_text|>", "eos_token": "<|eot_id|>", "pad_token": "<|pad|>",
        "chat_template": "{{ bos_token }}{% for m in messages %}<|start_header_id|>"
                         "{{ m['role'] }}<|end_header_id|>\n\n{{ m['content'] }}<|eot_id|>"
                         "{% endfor %}{% if add_generation_prompt %}<|start_header_id|>"
                         "assistant<|end_header_id|>\n\n{% endif %}"}))
    return d


def test_tensors_padding_and_chat_template_match_jax(chat_dir):
    jax_t = jax_tok.AutoTokenizer.from_pretrained(str(chat_dir))
    tok = port.AutoTokenizer.from_pretrained(chat_dir)
    texts = [CORPUS[0], CORPUS[10], CORPUS[12]]
    for side in ("left", "right"):
        jax_t.padding_side = tok.padding_side = side
        want = jax_t(texts, padding=True, return_tensors="np")
        got = tok(texts, padding=True, return_tensors="pt")
        for k in ("input_ids", "attention_mask"):
            assert got[k].dtype == torch.int64
            np.testing.assert_array_equal(got[k].numpy(), want[k])
        moved = got.to("cpu")
        assert isinstance(moved["input_ids"], torch.Tensor)
        feats = [{"input_ids": tok.encode(t)} for t in texts]
        np.testing.assert_array_equal(
            tok.pad(feats, return_tensors="pt")["input_ids"].numpy(),
            jax_t.pad(feats, return_tensors="np")["input_ids"])
    np.testing.assert_array_equal(tok(CORPUS[1], return_tensors="np")["input_ids"],
                                  jax_t(CORPUS[1], return_tensors="np")["input_ids"])
    messages = [{"role": "system", "content": "Be brief."},
                {"role": "user", "content": CORPUS[8]}]
    assert (tok.apply_chat_template(messages, add_generation_prompt=True)
            == jax_t.apply_chat_template(messages, add_generation_prompt=True))
    assert (tok.apply_chat_template(messages, tokenize=False)
            == jax_t.apply_chat_template(messages, tokenize=False))
    assert tok.batch_decode(want["input_ids"], skip_special_tokens=True) == \
        jax_t.batch_decode(want["input_ids"], skip_special_tokens=True)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tok.parse_response("<tool_call>{}</tool_call>", {"fields": {}})


def test_save_pretrained_round_trip(chat_dir, tmp_path):
    tok = port.AutoTokenizer.from_pretrained(chat_dir)
    tok.save_pretrained(tmp_path)
    again = port.AutoTokenizer.from_pretrained(tmp_path)
    assert again.encode(CORPUS[12]) == tok.encode(CORPUS[12])
    assert again.chat_template == tok.chat_template and again.eos_token == "<|eot_id|>"


def test_tiktoken_spm_and_vocab_txt_checkpoints_load_like_jax(trained_configs, tmp_path):
    """A Llama-3 checkpoint that ships tiktoken ranks as tokenizer.model, a
    SentencePiece .model and a BERT vocab.txt load through the converters."""
    cfg = json.loads((FIXTURE_DIR / "tokenizer.json").read_text())
    u2b = {v: k for k, v in bytes_to_unicode().items()}
    ranks = sorted((i, bytes(u2b[c] for c in t)) for t, i in cfg["model"]["vocab"].items()
                   if i < 3000 or len(t) == 1)
    tik = tmp_path / "tiktoken"
    tik.mkdir()
    import base64

    (tik / "tokenizer.model").write_text("".join(
        f"{base64.b64encode(b).decode()} {r}\n" for r, b in ranks))

    spm = tmp_path / "spm"
    spm.mkdir()
    (spm / "tokenizer.model").write_bytes(_spm_blob())

    vocab = tmp_path / "vocab_txt"
    vocab.mkdir()
    wp = json.loads(trained_configs["wordpiece_bert"])["model"]["vocab"]
    (vocab / "vocab.txt").write_text("".join(t + "\n" for t, _ in sorted(wp.items(),
                                                                        key=lambda kv: kv[1])))
    (vocab / "tokenizer_config.json").write_text(json.dumps({"do_lower_case": True}))
    for d in (tik, spm, vocab):
        jax_t = jax_tok.AutoTokenizer.from_pretrained(str(d))
        tok = port.AutoTokenizer.from_pretrained(d)
        for text in CORPUS[:4] + CORPUS[7:12]:
            ids = jax_t.encode(text)
            assert tok.encode(text) == ids, (d.name, text)
            assert tok.decode(ids) == jax_t.decode(ids), (d.name, text)


def _spm_blob() -> bytes:
    """A small SentencePiece ModelProto (Unigram, dummy prefix) in wire format."""
    def varint(n):
        out = b""
        while True:
            b, n = n & 0x7F, n >> 7
            out += bytes([b | (0x80 if n else 0)])
            if not n:
                return out

    def field(num, payload: bytes):
        return varint(num << 3 | 2) + varint(len(payload)) + payload

    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)] + [
        (p, -1.0 - 0.1 * i, 1) for i, p in enumerate(
            ["▁", "e", "a", "o", "n", "s", "t", "r", "l", "d", "h", "w", "▁t", "he", "▁the",
             "in", "er", "▁a", "on", "ll", "or", "ld", "▁w", "▁he", "llo", "▁hello"])]
    blob = b""
    for piece, score, ptype in pieces:
        blob += field(1, field(1, piece.encode()) + bytes([2 << 3 | 5]) + struct.pack("<f", score)
                      + varint(3 << 3) + varint(ptype))
    blob += field(2, varint(3 << 3) + varint(1) + varint(40 << 3) + varint(0))
    blob += field(3, varint(3 << 3) + varint(1))
    return blob


def test_failed_cpp_build_raises(tmp_path, monkeypatch, fixture_pair):
    broken = tmp_path / "bpe.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="C\\+\\+ BPE build failed"):
        native.build()
    # the engine does not fall back to the Python merge loop
    native.load.cache_clear()
    try:
        engine = TokenizerEngine(fixture_pair[1].config)
        for text in ("hello world", "and again"):
            with pytest.raises(RuntimeError, match="C\\+\\+ BPE build failed"):
                engine.encode(text)
    finally:
        native.load.cache_clear()


def test_local_directories_only(tmp_path):
    with pytest.raises(OSError, match="not a local directory"):
        port.AutoTokenizer.from_pretrained("meta-llama/Meta-Llama-3-8B")
    (tmp_path / "tokenizer_config.json").write_text(json.dumps({"tokenizer_class": "ByT5Tokenizer"}))
    with pytest.raises(NotImplementedError, match="ByT5Tokenizer"):
        port.AutoTokenizer.from_pretrained(tmp_path)


def test_fairseq_bpe_and_tool_schemas_match_jax(chat_dir, tmp_path):
    """The copied fairseq BPE (vocab.txt + bpe.codes) and the tool schemas a
    chat template renders from Python functions."""
    from transformers_tpu.tokenization.fairseq_bpe import FairseqBpeTokenizer as JaxFairseq

    from transformers_tpu_torch.tokenization.fairseq_bpe import FairseqBpeTokenizer

    (tmp_path / "vocab.txt").write_text("".join(f"{t} 1\n" for t in (
        "the", "qu@@", "ick", "br@@", "own", "fox", "o@@", "ver", "l@@", "a@@", "zy", "dog.",
        "t@@", "h@@", "e", "q@@", "u@@", "i@@", "c@@", "k", "b@@", "r@@", "w@@", "n")))
    (tmp_path / "bpe.codes").write_text("t h 10\nth e</w> 9\nq u 8\ni c 7\nic k</w> 6\n"
                                        "b r 5\no w 4\now n</w> 3\no v 2\nl a 1\n")
    text = "The quick brown fox jumps over the lazy dog. ſ \x1c x"
    jax_f = JaxFairseq.from_pretrained(tmp_path)
    port_f = FairseqBpeTokenizer.from_pretrained(tmp_path)
    ids = jax_f.encode(text)
    assert port_f.encode(text) == ids and port_f.decode(ids) == jax_f.decode(ids)

    def get_weather(city: str, unit: str = "celsius") -> dict:
        """Look up the weather.

        Args:
            city: The city to look up.
            unit: The unit of temperature (choices: ["celsius", "fahrenheit"])
        """

    template = "{% for t in tools %}{{ t | tojson }}\n{% endfor %}{{ messages[0]['content'] }}"
    messages = [{"role": "user", "content": "Weather in Paris?"}]
    want = jax_tok.AutoTokenizer.from_pretrained(str(chat_dir)).apply_chat_template(
        messages, chat_template=template, tools=[get_weather])
    assert port.AutoTokenizer.from_pretrained(chat_dir).apply_chat_template(
        messages, chat_template=template, tools=[get_weather]) == want
