"""Pipeline base (port of ``transformers_tpu/pipelines/base.py``; reference
src/transformers/pipelines/base.py:754 ``Pipeline.__call__`` ->
preprocess/_forward/postprocess :1146-1167). Inputs run one at a time, as in
the JAX package; a list of inputs gives a list of results."""

from __future__ import annotations

import numpy as np
import torch


class Pipeline:
    """Subclasses implement ``preprocess`` / ``_forward`` / ``postprocess`` and
    may override ``_sanitize_parameters`` to split keyword arguments between
    the three. The model's forwards run on its device, under
    ``torch.inference_mode``."""

    def __init__(self, model, tokenizer=None, **kwargs):
        self.model = model
        self.tokenizer = tokenizer
        self._init_kwargs = kwargs

    @property
    def device(self) -> torch.device:
        return self.model.device

    def encode(self, *texts, **kwargs) -> dict:
        """The tokenizer's tensors for ``texts`` (one text or a pair), on the
        model's device."""
        enc = self.tokenizer(*texts, return_tensors="pt", **kwargs)
        return {k: v.to(self.device) for k, v in enc.items()}

    def _sanitize_parameters(self, **kwargs) -> tuple[dict, dict, dict]:
        return {}, {}, kwargs

    def preprocess(self, inputs, **kwargs) -> dict:
        raise NotImplementedError

    def _forward(self, model_inputs: dict, **kwargs):
        raise NotImplementedError

    def postprocess(self, model_outputs, **kwargs):
        raise NotImplementedError

    def __call__(self, inputs, **kwargs):
        pre_kw, fwd_kw, post_kw = self._sanitize_parameters(**kwargs)
        batched = isinstance(inputs, list)
        items = inputs if batched else [inputs]
        outputs = [self.run_single(item, pre_kw, fwd_kw, post_kw) for item in items]
        return outputs if batched else outputs[0]

    def run_single(self, item, pre_kw, fwd_kw, post_kw):
        model_inputs = self.preprocess(item, **pre_kw)
        with torch.inference_mode():
            model_outputs = self._forward(model_inputs, **fwd_kw)
        return self.postprocess(model_outputs, **post_kw)


def softmax_np(x: np.ndarray, axis=-1) -> np.ndarray:
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A model output as a float32 numpy array on the host."""
    return t.detach().float().cpu().numpy()
