"""The port's encoders, task heads, auto classes and text pipelines against
the JAX package's, on the CPU, float32.

BERT, RoBERTa, XLM-RoBERTa and DistilBERT at 2 layers, ModernBERT at 3 (a
global layer, then two local ones with a window of 2 on each side), on a
right-padded batch of two lengths (BERT with both token types): the bare
model's last hidden state and every head's logits within 2e-5 of JAX. BERT
runs at head_dim 64, so the port's attention goes through the flash
wrapper (its plain version on CPU tensors, bidirectional); the others at
head_dim 16 through the eager path, as JAX's do on the CPU. RoBERTa's
position ids against JAX's ``position_ids_from_input_ids``. The decoder
heads of Llama, Mistral and Qwen2 (sequence classification pooled at the
last non-pad token, with a pad id inside a row and with no pad id; token
classification; QA) and their bare models. Each head loss with labels
(regression, single- and multi-label, token, QA with positions out of range,
masked LM) within 2e-5. ``from_pretrained`` of a JAX-saved BERT MLM and
RoBERTa classifier: no tied decoder stored or reported, the hub's tied and
``position_ids`` keys ignored. The seven text pipelines against JAX's on a
tiny model and a made-up WordPiece ``vocab.txt``: labels, tokens and answers
equal, scores within 1e-5; a registered task the port lacks raises.

Weights come from a numpy seed (``_numpy_params``) and reach the port
through ``params_from_jax``.
"""

import importlib
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transformers_tpu as ttpu
import transformers_tpu_torch as port
from transformers_tpu import loss as jax_loss
from transformers_tpu.modeling_layers import last_token_indices as jax_last_token_indices
from transformers_tpu.models.bert import modeling_bert as jax_bert
from transformers_tpu.models.distilbert import modeling_distilbert as jax_distilbert
from transformers_tpu.models.modernbert import modeling_modernbert as jax_modernbert
from transformers_tpu.models.roberta import modeling_roberta as jax_roberta
from transformers_tpu.models.xlm_roberta import modeling_xlm_roberta as jax_xlmr
from transformers_tpu_torch import loss as port_loss
from transformers_tpu_torch.modeling_layers import last_token_indices
from transformers_tpu_torch.models.roberta.modeling_roberta import position_ids_from_input_ids
from test_torch_llama import _numpy_params
from torch_port_testing import one_torch_thread  # noqa: F401

TOL = 2e-5
SCORE_TOL = 1e-5
VOCAB = 96
LENGTHS = (12, 7)  # a right-padded batch of two rows
ENCODER = dict(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
               intermediate_size=48, max_position_embeddings=40, num_labels=3)
FAMILIES = {  # model_type: (JAX config, {head: JAX class}, config overrides)
    "bert": (jax_bert.BertConfig, {
        "base": jax_bert.BertModelStandalone, "masked_lm": jax_bert.BertForMaskedLM,
        "sequence": jax_bert.BertForSequenceClassification,
        "token": jax_bert.BertForTokenClassification,
        "qa": jax_bert.BertForQuestionAnswering}, dict(hidden_size=128, intermediate_size=64)),
    "roberta": (jax_roberta.RobertaConfig, {
        "base": jax_roberta.RobertaModelStandalone, "masked_lm": jax_roberta.RobertaForMaskedLM,
        "sequence": jax_roberta.RobertaForSequenceClassification,
        "token": jax_roberta.RobertaForTokenClassification,
        "qa": jax_roberta.RobertaForQuestionAnswering}, {}),
    "xlm-roberta": (jax_xlmr.XLMRobertaConfig, {
        "base": jax_xlmr.XLMRobertaModelStandalone, "masked_lm": jax_xlmr.XLMRobertaForMaskedLM,
        "sequence": jax_roberta.RobertaForSequenceClassification,
        "token": jax_roberta.RobertaForTokenClassification,
        "qa": jax_roberta.RobertaForQuestionAnswering}, {}),
    "distilbert": (jax_distilbert.DistilBertConfig, {
        "base": jax_distilbert.DistilBertModelStandalone,
        "masked_lm": jax_distilbert.DistilBertForMaskedLM,
        "sequence": jax_distilbert.DistilBertForSequenceClassification,
        "qa": jax_distilbert.DistilBertForQuestionAnswering},
        dict(dim=32, n_layers=2, n_heads=2, hidden_dim=48)),
    "modernbert": (jax_modernbert.ModernBertConfig, {
        "base": jax_modernbert.ModernBertModelStandalone,
        "masked_lm": jax_modernbert.ModernBertForMaskedLM,
        "sequence": jax_modernbert.ModernBertForSequenceClassification,
        "token": jax_modernbert.ModernBertForTokenClassification},
        dict(num_hidden_layers=3, global_attn_every_n_layers=3, local_attention=4,
             pad_token_id=0, norm_bias=True)),
}
AUTO = {"base": port.AutoModel, "masked_lm": port.AutoModelForMaskedLM,
        "sequence": port.AutoModelForSequenceClassification,
        "token": port.AutoModelForTokenClassification,
        "qa": port.AutoModelForQuestionAnswering}
ENCODER_CASES = [(family, head) for family, (_, heads, _) in FAMILIES.items() for head in heads]


def _encoder_config(model_type: str) -> dict:
    cfg = dict(ENCODER, **FAMILIES[model_type][2])
    if model_type == "distilbert":
        for name in ("hidden_size", "num_hidden_layers", "num_attention_heads",
                     "intermediate_size"):
            cfg.pop(name)
    if model_type in ("roberta", "xlm-roberta"):
        cfg["max_position_embeddings"] = 40 + 2  # the pad offset
    return cfg


def _batch(model_type: str, pad_id: int, seed: int = 0) -> dict:
    """A right-padded batch of LENGTHS as numpy int32 arrays; BERT's second
    row with a second segment."""
    rng = np.random.default_rng(seed)
    s = max(LENGTHS)
    ids = rng.integers(3, VOCAB, (len(LENGTHS), s)).astype(np.int32)
    mask = np.zeros_like(ids)
    for row, n in enumerate(LENGTHS):
        mask[row, :n] = 1
        ids[row, n:] = pad_id
    batch = {"input_ids": ids, "attention_mask": mask}
    if model_type == "bert":
        types = np.zeros_like(ids)
        types[1, 4:LENGTHS[1]] = 1
        batch["token_type_ids"] = types
    return batch


def _outputs(out) -> dict:
    names = ("last_hidden_state", "pooler_output", "logits", "start_logits", "end_logits")
    return {n: getattr(out, n) for n in names if getattr(out, n, None) is not None}


def _close(port_out, jax_out, tol=TOL):
    a = port_out.detach().float().numpy()
    b = np.asarray(jax_out, np.float32)
    assert a.shape == b.shape
    err = float(np.abs(a - b).max())
    assert err < tol, f"max |port - jax| = {err}"


def _pair(jax_cls, jax_config, port_model_cls, seed: int, **port_kw):
    """A JAX model, its params from ``seed`` and the port's model with the
    same weights (float32, on the CPU)."""
    jax_model = jax_cls(jax_config, dtype=jnp.float32)
    params = _numpy_params(jax_model, seed)
    model = port_model_cls(dtype=torch.float32, device="cpu", **port_kw)
    missing, unexpected = model.load_state_dict(
        port.params_from_jax(jax.tree.map(np.asarray, params)), strict=False)
    assert not missing and not unexpected, (missing, unexpected)
    return jax_model, params, model


@pytest.mark.parametrize("family,head", ENCODER_CASES)
def test_encoder_heads_match_jax(family, head):
    jax_cfg_cls, heads, _ = FAMILIES[family]
    cfg = _encoder_config(family)
    config = port.AutoConfig.for_model_type(family, **cfg)
    jax_model, params, model = _pair(
        heads[head], jax_cfg_cls(**cfg), lambda **kw: AUTO[head].from_config(config, **kw),
        seed=len(family) + len(head))
    assert type(model).__name__ == heads[head].__name__
    batch = _batch(family, config.pad_token_id)
    ref = _outputs(jax.jit(lambda p, b: jax_model(p, **b))(params, batch))
    with torch.no_grad():
        out = _outputs(model(**{k: torch.as_tensor(v) for k, v in batch.items()}))
    assert sorted(out) == sorted(ref)
    for name in ref:
        _close(out[name], ref[name])


def test_roberta_position_ids_match_jax():
    ids = np.array([[0, 5, 9, 1, 1], [0, 7, 1, 4, 2]], np.int32)  # pad (1) mid-row too
    emb = jax_roberta.RobertaEmbeddings(jax_roberta.RobertaConfig(**ENCODER), dtype=jnp.float32,
                                        param_dtype=jnp.float32)
    ref = np.asarray(emb.position_ids_from_input_ids(jnp.asarray(ids)))
    got = position_ids_from_input_ids(torch.as_tensor(ids), padding_idx=1)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(ref, [[2, 3, 4, 1, 1], [2, 3, 1, 4, 5]])


def test_bert_attention_reaches_flash_bidirectional(monkeypatch):
    """The encoder's attention goes through the flash wrapper, not causal,
    with its rows' ``kv_valid`` (head_dim 64)."""
    from transformers_tpu_torch.ops import attention

    calls = []
    real = attention.flash_attention

    def spy(q, k, v, **kw):
        calls.append(kw)
        return real(q, k, v, **kw)

    monkeypatch.setattr(attention, "flash_attention", spy)
    cfg = _encoder_config("bert")
    model = port.BertModelStandalone(port.BertConfig(**cfg), device="cpu").init_weights(0)
    batch = _batch("bert", 0)
    with torch.no_grad():
        model(**{k: torch.as_tensor(v) for k, v in batch.items()})
    assert len(calls) == cfg["num_hidden_layers"]
    assert all(not c["is_causal"] and c["sliding_window"] is None for c in calls)
    assert calls[0]["kv_valid"].tolist() == batch["attention_mask"].tolist()


# ------------------------------------------------------------ decoder heads
DECODER = dict(vocab_size=VOCAB, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, head_dim=8,
               max_position_embeddings=64, num_labels=3, eos_token_id=2)
DECODER_FAMILIES = {"llama": "Llama", "mistral": "Mistral", "qwen2": "Qwen2"}
DECODER_HEADS = {"base": "ModelStandalone", "sequence": "ForSequenceClassification",
                 "token": "ForTokenClassification", "qa": "ForQuestionAnswering"}
DECODER_CASES = [(f, h, pad) for f in DECODER_FAMILIES for h in DECODER_HEADS
                 for pad in ((0, None) if h == "sequence" else (0,))]
# a pad id (0) inside row 0 and at its end; the mask keeps the inside one
DECODER_IDS = np.array([[5, 9, 0, 7, 11, 3, 0, 0], [4, 6, 8, 10, 12, 14, 16, 18]], np.int32)
DECODER_MASK = np.array([[1, 1, 1, 1, 1, 1, 0, 0], [1] * 8], np.int32)


@pytest.mark.parametrize("family,head,pad_id", DECODER_CASES)
def test_decoder_heads_match_jax(family, head, pad_id):
    cfg = dict(DECODER, pad_token_id=pad_id)
    jax_module = importlib.import_module(f"transformers_tpu.models.{family}")
    jax_cls = getattr(jax_module, DECODER_FAMILIES[family] + DECODER_HEADS[head])
    config = port.AutoConfig.for_model_type(family, **cfg)
    jax_model, params, model = _pair(
        jax_cls, getattr(jax_module, DECODER_FAMILIES[family] + "Config")(**cfg),
        lambda **kw: AUTO[head].from_config(config, **kw), seed=7 + len(family))
    assert type(model).__name__ == jax_cls.__name__
    batch = {"input_ids": DECODER_IDS, "attention_mask": DECODER_MASK}
    ref = _outputs(jax.jit(lambda p, b: jax_model(p, **b))(params, batch))
    with torch.no_grad():
        out = _outputs(model(**{k: torch.as_tensor(v) for k, v in batch.items()}))
    assert sorted(out) == sorted(ref)
    for name in ref:
        _close(out[name], ref[name])
    if head == "sequence":
        idx = last_token_indices(torch.as_tensor(DECODER_IDS), torch.as_tensor(DECODER_MASK),
                                 pad_id)
        ref_idx = jax_last_token_indices(jnp.asarray(DECODER_IDS), jnp.asarray(DECODER_MASK),
                                         pad_id)
        assert idx.tolist() == np.asarray(ref_idx).tolist() == [5, 7]


def test_last_token_indices_ignores_the_mask_when_there_is_a_pad_id():
    ids = torch.tensor([[5, 0, 7, 0], [3, 4, 0, 0]])
    mask = torch.tensor([[1, 1, 1, 1], [1, 1, 1, 1]])
    assert last_token_indices(ids, mask, 0).tolist() == [2, 1]
    assert last_token_indices(ids, mask, None).tolist() == [3, 3]
    assert (np.asarray(jax_last_token_indices(jnp.asarray(ids.numpy()), jnp.asarray(
        mask.numpy()), 0)).tolist() == [2, 1])


# ------------------------------------------------------------------- losses
def _loss_inputs(kind: str):
    rng = np.random.default_rng(len(kind))
    if kind == "regression":
        return rng.standard_normal((4, 1)), rng.standard_normal((4,)).astype(np.float32), 1
    if kind == "single_label":
        return rng.standard_normal((4, 3)), np.array([0, 2, 1, 2], np.int64), 3
    if kind == "multi_label":
        return rng.standard_normal((4, 3)), rng.integers(0, 2, (4, 3)).astype(np.float32), 3
    if kind == "token":
        labels = rng.integers(0, 3, (2, 6)).astype(np.int64)
        labels[0, 4:] = -100
        return rng.standard_normal((2, 6, 3)), labels, 3
    if kind == "masked_lm":
        labels = np.full((2, 6), -100, np.int64)
        labels[0, 1], labels[1, 3] = 17, 40
        return rng.standard_normal((2, 6, VOCAB)), labels, VOCAB
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["regression", "single_label", "multi_label", "token",
                                  "masked_lm"])
def test_head_losses_match_jax(kind):
    logits, labels, n = _loss_inputs(kind)
    cfg = SimpleNamespace(num_labels=n, problem_type=None)
    lt, yt = torch.as_tensor(logits, dtype=torch.float32), torch.as_tensor(labels)
    lj, yj = jnp.asarray(logits, jnp.float32), jnp.asarray(labels)
    if kind == "token":
        got = port_loss.for_token_classification_loss(lt, yt, cfg)
        ref = jax_loss.for_token_classification_loss(lj, yj, cfg)
    elif kind == "masked_lm":
        got = port_loss.for_masked_lm_loss(lt, yt, n)
        ref = jax_loss.for_masked_lm_loss(lj, yj, n)
    else:
        got = port_loss.for_sequence_classification_loss(lt, yt, cfg)
        ref = jax_loss.for_sequence_classification_loss(lj, yj, cfg)
    assert abs(float(got) - float(ref)) < TOL


def test_question_answering_loss_clamps_positions_like_jax():
    rng = np.random.default_rng(3)
    start, end = rng.standard_normal((2, 2, 9))
    sp, ep = np.array([2, 40]), np.array([-5, 8])  # out of range: clamped; 9 is ignored
    got = port_loss.for_question_answering_loss(*(torch.as_tensor(x, dtype=torch.float32)
                                                  for x in (start, end)),
                                                torch.as_tensor(sp), torch.as_tensor(ep))
    ref = jax_loss.for_question_answering_loss(jnp.asarray(start, jnp.float32),
                                               jnp.asarray(end, jnp.float32),
                                               jnp.asarray(sp), jnp.asarray(ep))
    assert abs(float(got) - float(ref)) < TOL


def test_heads_compute_their_loss_from_labels():
    cfg = _encoder_config("bert")
    jax_model, params, model = _pair(
        jax_bert.BertForSequenceClassification, jax_bert.BertConfig(**cfg),
        lambda **kw: port.BertForSequenceClassification(port.BertConfig(**cfg), **kw), seed=3)
    batch = _batch("bert", 0)
    labels = np.array([2, 0], np.int32)
    ref = jax.jit(lambda p, b, y: jax_model(p, **b, labels=y).loss)(params, batch,
                                                                    jnp.asarray(labels))
    with torch.no_grad():
        got = model(**{k: torch.as_tensor(v) for k, v in batch.items()},
                    labels=torch.as_tensor(labels)).loss
    assert abs(float(got) - float(ref)) < TOL


# ------------------------------------------------------------ from_pretrained
@pytest.mark.parametrize("family,head", [("bert", "masked_lm"), ("roberta", "sequence")])
def test_from_pretrained_of_a_jax_checkpoint(family, head, tmp_path):
    from transformers_tpu_torch.core.safetensors import load_file, save_file

    jax_cfg_cls, heads, _ = FAMILIES[family]
    cfg = _encoder_config(family)
    jax_model = heads[head](jax_cfg_cls(**cfg), dtype=jnp.float32)
    params = _numpy_params(jax_model, 11)
    jax_model.save_pretrained(str(tmp_path / "jax"), params=params)
    model = AUTO[head].from_pretrained(tmp_path / "jax", device="cpu")
    assert type(model).__name__ == heads[head].__name__
    report = model.load_report
    assert not report.missing_keys and not report.unexpected_keys
    tied = "cls.predictions.decoder.weight" if family == "bert" else "lm_head.decoder.weight"
    assert tied not in model.state_dict()
    # the hub's tied duplicate and position_ids buffer are dropped without a report
    path = tmp_path / "jax" / "model.safetensors"
    tensors = load_file(str(path))
    tensors[f"{family}.embeddings.position_ids"] = torch.arange(cfg["max_position_embeddings"])
    if family == "bert":
        tensors[tied] = tensors["bert.embeddings.word_embeddings.weight"]
    save_file(tensors, str(path), metadata={"format": "pt"})
    again = AUTO[head].from_pretrained(tmp_path / "jax", device="cpu")
    assert not again.load_report.unexpected_keys and not again.load_report.missing_keys
    again.save_pretrained(tmp_path / "port")
    assert tied not in load_file(str(tmp_path / "port" / "model.safetensors"))
    batch = _batch(family, again.config.pad_token_id)
    ref = _outputs(jax.jit(lambda p, b: jax_model(p, **b))(params, batch))
    with torch.no_grad():
        out = _outputs(again(**{k: torch.as_tensor(v) for k, v in batch.items()}))
    for name in ref:
        _close(out[name], ref[name])


def test_auto_classes_refuse_what_they_do_not_map():
    with pytest.raises(ValueError, match="'distilbert'"):
        port.AutoModelForTokenClassification.from_config(
            port.AutoConfig.for_model_type("distilbert"), device="cpu")
    with pytest.raises(ValueError, match="'gpt2'"):
        port.AutoModel.from_config(SimpleNamespace(model_type="gpt2"), device="cpu")
    # each task class holds exactly the JAX package's rows for the families the port has
    from transformers_tpu.models.auto import modeling_auto
    from transformers_tpu_torch.models.auto import CONFIG_MAPPING

    for auto, names in ((port.AutoModel, modeling_auto.MODEL_MAPPING_NAMES),
                        (port.AutoModelForMaskedLM,
                         modeling_auto.MODEL_FOR_MASKED_LM_MAPPING_NAMES),
                        (port.AutoModelForSequenceClassification,
                         modeling_auto.MODEL_FOR_SEQUENCE_CLASSIFICATION_MAPPING_NAMES),
                        (port.AutoModelForTokenClassification,
                         modeling_auto.MODEL_FOR_TOKEN_CLASSIFICATION_MAPPING_NAMES),
                        (port.AutoModelForQuestionAnswering,
                         modeling_auto.MODEL_FOR_QUESTION_ANSWERING_MAPPING_NAMES)):
        assert {t: c.__name__ for t, c in auto._model_mapping.items()} == {
            t: name for t, (_, name) in names.items() if t in CONFIG_MAPPING}, auto.__name__


# ----------------------------------------------------------------- pipelines
WORDS = ("the cat sat on mat dog ran fast a slow red blue green house tree is was big small "
         "paris france city capital of in where who what likes to eat fish good bad movie "
         "great day night john lives london").split()
LABELS3 = {0: "contradiction", 1: "neutral", 2: "entailment"}
TAGS = {0: "O", 1: "B-PER", 2: "B-LOC"}
PIPELINE_MODELS = {  # task: (JAX class, config overrides)
    "text-classification": (jax_bert.BertForSequenceClassification, dict(id2label=LABELS3)),
    "zero-shot-classification": (jax_bert.BertForSequenceClassification,
                                 dict(id2label=LABELS3)),
    "token-classification": (jax_bert.BertForTokenClassification, dict(id2label=TAGS)),
    "fill-mask": (jax_bert.BertForMaskedLM, {}),
    "feature-extraction": (jax_bert.BertModelStandalone, {}),
    "question-answering": (jax_bert.BertForQuestionAnswering, {}),
}
PIPELINE_INPUTS = {
    "text-classification": (("the cat sat on the mat",), {"top_k": 3}),
    "zero-shot-classification": (("john likes to eat fish",),
                                 {"candidate_labels": ["good", "bad", "city"]}),
    "token-classification": (("john lives in london",), {}),
    "fill-mask": (("the cat [MASK] on the mat",), {"top_k": 3}),
    "feature-extraction": (("a red house",), {}),
    "question-answering": ((), {"question": "where is paris", "context":
                                "paris is the capital of france and a big city",
                                "top_k": 2}),
    "text-generation": (("the dog ran",), {"max_new_tokens": 6}),
}


def _write_tokenizer(directory):
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + list(WORDS) + [
        "##s", "##ed", "##ing"]
    vocab += [f"[unused{i}]" for i in range(VOCAB - len(vocab))]
    (directory / "vocab.txt").write_text("".join(t + "\n" for t in vocab))
    (directory / "tokenizer_config.json").write_text(json.dumps({
        "do_lower_case": True, "mask_token": "[MASK]", "pad_token": "[PAD]",
        "cls_token": "[CLS]", "sep_token": "[SEP]", "unk_token": "[UNK]"}))


@pytest.fixture(scope="module")
def pipeline_dirs(tmp_path_factory):
    """One checkpoint directory per task, each with the WordPiece tokenizer."""
    root = tmp_path_factory.mktemp("pipelines")
    dirs = {}
    for task, (jax_cls, extra) in PIPELINE_MODELS.items():
        d = root / task
        d.mkdir()
        cfg = dict(ENCODER, **extra)
        cfg.pop("num_labels", None) if "id2label" in extra else None
        jax_model = jax_cls(jax_bert.BertConfig(**cfg), dtype=jnp.float32)
        jax_model.save_pretrained(str(d), params=_numpy_params(jax_model, len(task)))
        _write_tokenizer(d)
        dirs[task] = d
    d = root / "text-generation"
    d.mkdir()
    jax_model = ttpu.LlamaForCausalLM(ttpu.LlamaConfig(**dict(
        DECODER, pad_token_id=0, eos_token_id=3, bos_token_id=2)), dtype=jnp.float32)
    jax_model.save_pretrained(str(d), params=_numpy_params(jax_model, 5))
    _write_tokenizer(d)
    dirs["text-generation"] = d
    return dirs


class _Compiled:
    """A JAX model whose call is compiled once per input shape (the same
    function the pipeline's op-by-op call computes, without compiling each
    operation on its own)."""

    def __init__(self, model):
        self._model = model
        self._call = jax.jit(lambda params, inputs: model(params, **inputs))

    def __call__(self, params, **inputs):
        return self._call(params, inputs)

    def __getattr__(self, name):
        return getattr(self._model, name)


def _same(a, b):
    """Equal structure and values; floats within SCORE_TOL."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, float):
        assert abs(a - float(b)) < SCORE_TOL, (a, b)
    else:
        assert a == b


@pytest.mark.parametrize("task", list(PIPELINE_INPUTS))
def test_pipelines_match_jax(task, pipeline_dirs):
    args, kwargs = PIPELINE_INPUTS[task]
    ours = port.pipeline(task, model=str(pipeline_dirs[task]), device="cpu")
    theirs = ttpu.pipeline(task, model=str(pipeline_dirs[task]))
    # generate() compiles its own steps; zero-shot's three scores lie within
    # 1e-7 of each other on this model, so the reference keeps its own rounding
    if task not in ("text-generation", "zero-shot-classification"):
        theirs.model = _Compiled(theirs.model)
    assert ours.model.device.type == "cpu"
    got, ref = ours(*args, **kwargs), theirs(*args, **kwargs)
    _same(got, ref)
    if task in ("text-classification", "zero-shot-classification", "fill-mask"):
        assert len(got if task != "zero-shot-classification" else got["labels"]) == 3


def test_pipeline_refuses_a_task_the_port_lacks(pipeline_dirs):
    with pytest.raises(NotImplementedError, match="summarization"):
        port.pipeline("summarization", model=str(pipeline_dirs["fill-mask"]), device="cpu")
    with pytest.raises(KeyError, match="no-such-task"):
        port.pipeline("no-such-task", model=str(pipeline_dirs["fill-mask"]), device="cpu")
