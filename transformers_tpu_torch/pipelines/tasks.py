"""The text task pipelines (port of the text tasks of
``transformers_tpu/pipelines/tasks.py``: text generation, text, token and
zero-shot classification, fill-mask, feature extraction and extractive
question answering; reference src/transformers/pipelines/*.py). Each
computes what the JAX pipeline computes; the model runs on its device and
the postprocessing on the host in numpy, as in the JAX package."""

from __future__ import annotations

import numpy as np
import torch

from .base import Pipeline, softmax_np, to_numpy


class TextGenerationPipeline(Pipeline):
    """reference pipelines/text_generation.py (chat-aware :507), over the
    port's ``generate``."""

    def __call__(self, inputs, **kwargs):
        # a list of {"role", "content"} dicts is ONE chat, not a batch
        if (isinstance(inputs, list) and inputs and isinstance(inputs[0], dict)
                and "role" in inputs[0]):
            pre, fwd, post = self._sanitize_parameters(**kwargs)
            return self.run_single(inputs, pre, fwd, post)
        return super().__call__(inputs, **kwargs)

    def _sanitize_parameters(self, **kwargs):
        post = {k: kwargs.pop(k) for k in ("return_full_text",) if k in kwargs}
        return {}, kwargs, post

    def preprocess(self, inputs, **kwargs):
        if isinstance(inputs, list) and inputs and isinstance(inputs[0], dict):
            ids = self.tokenizer.apply_chat_template(inputs, add_generation_prompt=True)
            return {"input_ids": ids, "prompt_is_chat": True, "messages": inputs}
        return {"input_ids": self.tokenizer.encode(inputs), "prompt_is_chat": False,
                "prompt_text": inputs}

    def _forward(self, model_inputs, **generate_kwargs):
        generate_kwargs.setdefault("max_new_tokens", 32)
        # bucket == prompt length, so the generated tail starts at the prompt's length
        generate_kwargs.setdefault("prompt_pad_multiple", 1)
        ids = torch.tensor([model_inputs["input_ids"]], dtype=torch.long, device=self.device)
        out = self.model.generate(ids, **generate_kwargs)
        return {"sequences": out.cpu().numpy(), "inputs": model_inputs}

    def postprocess(self, model_outputs, return_full_text: bool = True):
        inputs = model_outputs["inputs"]
        gen_ids = model_outputs["sequences"][0][len(inputs["input_ids"]):]
        text = self.tokenizer.decode([int(t) for t in gen_ids], skip_special_tokens=True)
        if inputs.get("prompt_is_chat"):
            return [{"generated_text": inputs["messages"]
                     + [{"role": "assistant", "content": text}]}]
        prefix = inputs.get("prompt_text", "") if return_full_text else ""
        return [{"generated_text": prefix + text}]


class TextClassificationPipeline(Pipeline):
    """reference pipelines/text_classification.py."""

    def preprocess(self, inputs, **kwargs):
        return self.encode(inputs)

    def _forward(self, model_inputs, **kwargs):
        return to_numpy(self.model(**model_inputs).logits)

    def postprocess(self, logits, top_k: int = 1):
        probs = softmax_np(logits)[0]
        id2label = self.model.config.id2label or {i: f"LABEL_{i}" for i in range(len(probs))}
        order = np.argsort(-probs)[:top_k]
        out = [{"label": id2label[int(i)], "score": float(probs[i])} for i in order]
        return out[0] if top_k == 1 else out


class TokenClassificationPipeline(Pipeline):
    """reference pipelines/token_classification.py (simple aggregation:
    every token whose label is not ``O``)."""

    def preprocess(self, inputs, **kwargs):
        return self.encode(inputs)

    def _forward(self, model_inputs, **kwargs):
        return {"logits": to_numpy(self.model(**model_inputs).logits),
                "input_ids": model_inputs["input_ids"].cpu().numpy()}

    def postprocess(self, model_outputs, **kwargs):
        probs = softmax_np(model_outputs["logits"][0])
        id2label = self.model.config.id2label or {}
        entities = []
        for idx, (tok_id, p) in enumerate(zip(model_outputs["input_ids"][0], probs)):
            label_id = int(np.argmax(p))
            label = id2label.get(label_id, f"LABEL_{label_id}")
            if label == "O":
                continue
            entities.append({"entity": label, "score": float(p[label_id]), "index": idx,
                             "word": self.tokenizer.decode([int(tok_id)])})
        return entities


class FillMaskPipeline(Pipeline):
    """reference pipelines/fill_mask.py."""

    def preprocess(self, inputs, **kwargs):
        return self.encode(inputs)

    def _forward(self, model_inputs, **kwargs):
        return {"logits": to_numpy(self.model(**model_inputs).logits),
                "input_ids": model_inputs["input_ids"].cpu().numpy()}

    def postprocess(self, model_outputs, top_k: int = 5):
        ids = model_outputs["input_ids"][0]
        results = []
        for pos in np.where(ids == self.tokenizer.mask_token_id)[0]:
            probs = softmax_np(model_outputs["logits"][0, pos])
            results.append([
                {"token": int(t), "token_str": self.tokenizer.decode([int(t)]),
                 "score": float(probs[t]),
                 "sequence": self.tokenizer.decode(
                     [int(x) if i != pos else int(t) for i, x in enumerate(ids)],
                     skip_special_tokens=True)}
                for t in np.argsort(-probs)[:top_k]])
        return results[0] if len(results) == 1 else results


class FeatureExtractionPipeline(Pipeline):
    """reference pipelines/feature_extraction.py: the last hidden state."""

    def preprocess(self, inputs, **kwargs):
        return self.encode(inputs)

    def _forward(self, model_inputs, **kwargs):
        return to_numpy(self.model(**model_inputs).last_hidden_state)

    def postprocess(self, hidden, **kwargs):
        return hidden.tolist()


class QuestionAnsweringPipeline(Pipeline):
    """reference pipelines/question_answering.py, as the JAX package decodes
    spans: the joint argmax of start + end logits over spans of at most
    ``max_answer_len`` tokens. The question and context go in as a pair, and
    the forward takes no ``token_type_ids`` (the JAX pipeline drops them)."""

    def __call__(self, question=None, context=None, **kwargs):
        if isinstance(question, dict):
            return super().__call__(question, **kwargs)
        return super().__call__({"question": question, "context": context}, **kwargs)

    def preprocess(self, inputs, **kwargs):
        return self.encode(inputs["question"], inputs["context"], return_token_type_ids=True)

    def _forward(self, model_inputs, **kwargs):
        out = self.model(**{k: v for k, v in model_inputs.items() if k != "token_type_ids"})
        return {"start": to_numpy(out.start_logits)[0], "end": to_numpy(out.end_logits)[0],
                "input_ids": model_inputs["input_ids"].cpu().numpy()[0]}

    def postprocess(self, model_outputs, top_k: int = 1, max_answer_len: int = 15):
        start, end, ids = model_outputs["start"], model_outputs["end"], model_outputs["input_ids"]
        scores = start[:, None] + end[None, :]
        mask = np.triu(np.ones_like(scores, dtype=bool))
        mask &= np.tril(np.ones_like(scores, dtype=bool), k=max_answer_len - 1)
        scores = np.where(mask, scores, -np.inf)
        order = np.argsort(-scores.reshape(-1))[:top_k]
        p_start, p_end = softmax_np(start), softmax_np(end)
        results = []
        for idx in order:
            s, e = divmod(int(idx), scores.shape[1])
            answer = self.tokenizer.decode([int(t) for t in ids[s:e + 1]],
                                           skip_special_tokens=True).strip()
            results.append({"answer": answer, "score": float(p_start[s] * p_end[e]),
                            "start": s, "end": e})
        return results[0] if top_k == 1 else results


class ZeroShotClassificationPipeline(Pipeline):
    """reference pipelines/zero_shot_classification.py (NLI): each candidate
    label's hypothesis scored by the entailment class's probability (the
    ``label2id`` entry named "entailment", -1 when there is none), then
    normalized over the labels."""

    def __call__(self, sequences, candidate_labels=None,
                 hypothesis_template="This example is {}.", **kwargs):
        batched = isinstance(sequences, list)
        items = sequences if batched else [sequences]
        outs = [self._classify(s, candidate_labels, hypothesis_template) for s in items]
        return outs if batched else outs[0]

    def _entailment_index(self) -> int:
        label2id = {k.lower(): v for k, v in (self.model.config.label2id or {}).items()}
        return label2id.get("entailment", -1)

    def _classify(self, sequence, labels, template):
        entail = self._entailment_index()
        scores = []
        for label in labels:
            with torch.inference_mode():
                logits = to_numpy(self.model(**self.encode(sequence, template.format(label)))
                                  .logits)[0]
            scores.append(float(softmax_np(logits)[entail]))
        scores = np.asarray(scores)
        scores = scores / scores.sum()
        order = np.argsort(-scores)
        return {"sequence": sequence, "labels": [labels[i] for i in order],
                "scores": [float(scores[i]) for i in order]}
