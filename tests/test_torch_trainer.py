"""The port's training path (loss, gradients, ``Trainer``, schedules) on the
CPU, against the JAX package.

A tiny Llama (2 layers, hidden 128, 2 query heads over 1 kv head) at head_dim
64, a width the flash kernels take: the port's attention goes through
``flash_attention`` and its ``autograd.Function`` (whose wrappers run the
plain forward and backward on CPU tensors), while the JAX package takes its
eager route on the CPU. Weights are made from a numpy seed in JAX's layout
and carried to the port by ``params_from_jax``; everything is float32.

Tolerances: loss and gradients atol 2e-5 / rtol 1e-4 (two frameworks, two
summation orders, through 2 layers); the Trainers' logs and final weights
1e-5 after 4 AdamW steps. The JAX Trainer splits a batch over the 8 CPU
devices of the test mesh (``train_batch_size`` = per-device x 8); the port
trains on one device, so it gets 8x JAX's per-device batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transformers_tpu as ttpu
import transformers_tpu_torch as port
from transformers_tpu import optimization as jax_opt
from transformers_tpu.trainer import Trainer as JaxTrainer
from transformers_tpu.training_args import TrainingArguments as JaxArgs
from transformers_tpu_torch import optimization as port_opt
from transformers_tpu_torch.data import default_data_collator
from transformers_tpu_torch.training_args import ParallelismConfig
from torch_port_testing import one_torch_thread  # noqa: F401

CONFIG = dict(vocab_size=128, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
              num_attention_heads=2, num_key_value_heads=1, head_dim=64,
              max_position_embeddings=64, rms_norm_eps=1e-5)
SEQ = 16


def _numpy_params(jax_model, seed=0):
    rng = np.random.default_rng(seed)

    def draw(path, s):
        if "norm" in jax.tree_util.keystr(path):
            return jnp.asarray(1.0 + 0.1 * rng.standard_normal(s.shape), jnp.float32)
        return jnp.asarray(0.05 * rng.standard_normal(s.shape), jnp.float32)

    return jax.tree_util.tree_map_with_path(draw, jax_model.init_abstract())


def _port_model(params=None, seed=0):
    model = port.LlamaForCausalLM(port.LlamaConfig(**CONFIG), device="cpu")
    if params is None:
        return model.init_weights(seed)
    missing, unexpected = model.load_state_dict(
        port.params_from_jax(jax.tree.map(np.asarray, params)), strict=False)
    assert not missing and not unexpected
    return model


def _dataset(n, seed, padded=True):
    """Rows of SEQ tokens, right-padded to lengths of 8-16 (attention_mask 0,
    labels -100 on the pad)."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        ids = rng.integers(1, CONFIG["vocab_size"], SEQ)
        n_live = int(rng.integers(8, SEQ + 1)) if padded else SEQ
        mask = (np.arange(SEQ) < n_live).astype(np.int32)
        ids = np.where(mask == 1, ids, 0)
        rows.append({"input_ids": ids, "attention_mask": mask,
                     "labels": np.where(mask == 1, ids, -100)})
    return rows


def _port_named(jax_tree) -> dict:
    return port.params_from_jax(jax.tree.map(np.asarray, jax_tree))


@pytest.fixture(scope="module")
def jax_pair():
    jax_model = ttpu.LlamaForCausalLM(ttpu.LlamaConfig(**CONFIG), dtype=jnp.float32)
    return jax_model, _numpy_params(jax_model)


@pytest.fixture(scope="module")
def batch():
    return default_data_collator(_dataset(4, seed=1))


def test_loss_and_every_gradient_match_jax_value_and_grad(jax_pair, batch):
    jax_model, params = jax_pair
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    loss_ref, grads_ref = jax.jit(jax.value_and_grad(
        lambda p: jax_model(p, **jbatch).loss))(params)
    model = _port_model(params)
    loss = model(**batch).loss
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_ref), atol=2e-5, rtol=1e-4)
    ref = _port_named(grads_ref)
    assert set(ref) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), atol=2e-5, rtol=1e-4,
                                   err_msg=name)


def test_gradient_checkpointing_gives_the_same_gradients(jax_pair, batch):
    grads = []
    for enable in (False, True):
        model = _port_model(jax_pair[1])
        model.gradient_checkpointing_enable(enable)
        model(**batch).loss.backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        np.testing.assert_allclose(grads[1][name].numpy(), g.numpy(), rtol=1e-6, atol=0)


def test_label_smoothing_matches_jax(jax_pair, batch):
    jax_model, params = jax_pair
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    ref = jax.jit(lambda p, b: JaxTrainer._smoothed_loss(jax_model, p, b, 0.1))(params, jbatch)
    got = port.Trainer._smoothed_loss(_port_model(params), batch, 0.1)
    np.testing.assert_allclose(float(got.detach()), float(ref), atol=2e-5, rtol=1e-4)


# ------------------------------------------------------------------ Trainer
TRAIN = dict(learning_rate=5e-3, weight_decay=0.01, max_grad_norm=1.0,
             lr_scheduler_type="linear", warmup_steps=2, max_steps=4, logging_steps=1,
             save_strategy="no", seed=0, optim="adamw")


@pytest.fixture(scope="module")
def trained(jax_pair, tmp_path_factory):
    """The JAX and the port Trainer on the same weights and 16 padded rows."""
    jax_model, params = jax_pair
    data = _dataset(16, seed=2)
    out = tmp_path_factory.mktemp("trainers")
    jax_model.params = jax.tree.map(jnp.array, params)  # the JAX step donates its params
    jt = JaxTrainer(jax_model, JaxArgs(output_dir=str(out / "jax"),
                                       per_device_train_batch_size=1, **TRAIN),
                    train_dataset=data)
    jt.train()
    model = _port_model(params)
    pt = port.Trainer(model, port.TrainingArguments(
        output_dir=str(out / "port"), per_device_train_batch_size=len(jax.devices()), **TRAIN),
        train_dataset=data)
    pt.train()
    return jt, pt


@pytest.mark.parametrize("key", ["loss", "learning_rate", "grad_norm", "epoch", "step"])
def test_trainer_logs_match_jax(trained, key):
    jt, pt = trained
    ref = [e[key] for e in jt.state.log_history if key in e]
    got = [e[key] for e in pt.state.log_history if key in e]
    assert len(got) == len(ref) == TRAIN["max_steps"]
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_trainer_final_weights_match_jax(trained):
    jt, pt = trained
    ref = _port_named(jt.params)
    for name, p in pt.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("warmup", [0, 3])
@pytest.mark.parametrize("name", list(jax_opt.TYPE_TO_SCHEDULER_FUNCTION))
def test_schedule_matches_jax(name, warmup):
    kwargs = {"min_lr_rate": 0.1} if name == "cosine_with_min_lr" else None
    ref = jax_opt.get_scheduler(name, 0.1, warmup, 10, kwargs)
    got = port_opt.get_scheduler(name, 0.1, warmup, 10, kwargs)
    np.testing.assert_allclose([got(s) for s in range(13)], [float(ref(s)) for s in range(13)],
                               rtol=1e-6, atol=1e-9)


# --------------------------------------------------------------- port only
def _train(tmp_path, data, **kw):
    args = dict(TRAIN, lr_scheduler_type="constant", warmup_steps=0)
    args.update(kw)
    trainer = port.Trainer(_port_model(seed=0), port.TrainingArguments(
        output_dir=str(tmp_path), **args), train_dataset=data)
    trainer.train()
    return trainer, [e["loss"] for e in trainer.state.log_history if "loss" in e]


def test_gradient_accumulation_equals_one_big_batch(tmp_path):
    """GA=2 over micro-batches of 4 == GA=1 over batches of 8 (rows of equal
    length, so each micro-batch's token mean weighs the same). SGD, so the
    weights show the accumulated gradients themselves: AdamW's first step
    moves each weight by about lr whatever its gradient's size, so gradients
    near 0 that differ in the last bits would move it apart."""
    data = _dataset(16, seed=3, padded=False)
    t1, l1 = _train(tmp_path / "ga1", data, per_device_train_batch_size=8, max_steps=3,
                    optim="sgd")
    t2, l2 = _train(tmp_path / "ga2", data, per_device_train_batch_size=4,
                    gradient_accumulation_steps=2, max_steps=3, optim="sgd")
    np.testing.assert_allclose(l2, l1, atol=1e-5)
    for (name, a), b in zip(t1.model.named_parameters(), t2.model.parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(), atol=1e-5,
                                   err_msg=name)


def test_checkpoint_resume_reproduces_steps_5_to_8(tmp_path):
    data = _dataset(16, seed=4)
    kw = dict(per_device_train_batch_size=4, max_steps=8, save_strategy="steps", save_steps=4,
              lr_scheduler_type="linear", warmup_steps=2)
    full, losses = _train(tmp_path / "full", data, **kw)
    ckpt = tmp_path / "full" / "checkpoint-4"
    assert (ckpt / "optimizer" / "optimizer.pt").is_file()
    resumed = port.Trainer(_port_model(seed=7), port.TrainingArguments(
        output_dir=str(tmp_path / "resumed"), **dict(TRAIN, **kw)), train_dataset=data)
    resumed.train(resume_from_checkpoint=str(ckpt))
    after = [e["loss"] for e in resumed.state.log_history if "loss" in e and e["step"] > 4]
    np.testing.assert_allclose(after, losses[4:], atol=1e-6)


def test_evaluate_and_predict(tmp_path, batch):
    model = _port_model(seed=0)
    trainer = port.Trainer(model, port.TrainingArguments(
        output_dir=str(tmp_path), per_device_eval_batch_size=4),
        eval_dataset=_dataset(4, seed=1))
    metrics = trainer.evaluate()
    with torch.no_grad():
        expected = float(model(**batch).loss)
    np.testing.assert_allclose(metrics["eval_loss"], expected, rtol=1e-6)
    logits, labels = trainer.predict(_dataset(4, seed=1))
    assert logits.shape == (4, SEQ, CONFIG["vocab_size"]) and labels.shape == (4, SEQ)


def test_training_args_one_card():
    with pytest.raises(ValueError, match="one card"):
        port.TrainingArguments(parallelism_config=ParallelismConfig(dp_size=2))
    args = port.TrainingArguments(fp16=True, per_device_train_batch_size=3)
    assert args.bf16 and not args.fp16 and args.train_batch_size == 3


class _PadTokenizer:
    """The slice of a tokenizer the collators call: right-padding with id 0."""

    pad_token_id = 0
    mask_token_id = None

    def pad(self, features, padding=True, max_length=None, pad_to_multiple_of=None,
            return_tensors="np"):
        n = max(len(f["input_ids"]) for f in features)
        if pad_to_multiple_of:
            n = -(-n // pad_to_multiple_of) * pad_to_multiple_of
        ids = np.zeros((len(features), n), np.int64)
        mask = np.zeros((len(features), n), np.int64)
        for i, f in enumerate(features):
            ids[i, :len(f["input_ids"])] = f["input_ids"]
            mask[i, :len(f["input_ids"])] = 1
        out = {"input_ids": ids, "attention_mask": mask}
        if "label" in features[0]:
            out["label"] = np.asarray([f["label"] for f in features])
        return out


@pytest.mark.parametrize("collator", ["default", "with_padding", "lm_dicts", "lm_arrays"])
def test_collators_match_jax(collator):
    import transformers_tpu.data as jax_data
    import transformers_tpu_torch.data as port_data

    tok = _PadTokenizer()
    ragged = [{"input_ids": [5, 6, 7], "label": 1}, {"input_ids": [8, 9, 10, 11, 12], "label": 0}]
    make = {
        "default": (lambda m: m.default_data_collator, _dataset(3, seed=5)),
        "with_padding": (lambda m: m.DataCollatorWithPadding(tok, pad_to_multiple_of=8), ragged),
        "lm_dicts": (lambda m: m.DataCollatorForLanguageModeling(tok, mlm=False),
                     [{"input_ids": f["input_ids"]} for f in ragged]),
        "lm_arrays": (lambda m: m.DataCollatorForLanguageModeling(tok, mlm=False),
                      [np.array([3, 0, 4]), np.array([5, 6, 0])]),
    }
    build, features = make[collator]
    ref = build(jax_data)(features)
    got = build(port_data)(features)
    assert sorted(got) == sorted(ref)
    for key, value in got.items():
        assert isinstance(value, torch.Tensor)
        np.testing.assert_array_equal(value.numpy(), np.asarray(ref[key]), err_msg=key)
