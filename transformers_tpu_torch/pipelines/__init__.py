"""``pipeline()`` and its task registry (port of
``transformers_tpu/pipelines/__init__.py``; reference
src/transformers/pipelines/__init__.py:387 ``pipeline``, :141
``SUPPORTED_TASKS``, :136 ``TASK_ALIASES``, :323 ``check_task``).

The port has the JAX package's seven text tasks. The other tasks the JAX
package registers (image, audio, video, seq2seq and multimodal) need models
the port does not have yet: asking for one raises, naming it.
"""

from __future__ import annotations

from ..modeling_utils import resolve_device
from .base import Pipeline, softmax_np
from .tasks import (FeatureExtractionPipeline, FillMaskPipeline, QuestionAnsweringPipeline,
                    TextClassificationPipeline, TextGenerationPipeline,
                    TokenClassificationPipeline, ZeroShotClassificationPipeline)

# task -> (pipeline class, the auto class that loads its model)
SUPPORTED_TASKS = {
    "text-generation": (TextGenerationPipeline, "AutoModelForCausalLM"),
    "text-classification": (TextClassificationPipeline, "AutoModelForSequenceClassification"),
    "token-classification": (TokenClassificationPipeline, "AutoModelForTokenClassification"),
    "fill-mask": (FillMaskPipeline, "AutoModelForMaskedLM"),
    "feature-extraction": (FeatureExtractionPipeline, "AutoModel"),
    "question-answering": (QuestionAnsweringPipeline, "AutoModelForQuestionAnswering"),
    "zero-shot-classification": (ZeroShotClassificationPipeline,
                                 "AutoModelForSequenceClassification"),
}
# registered in the JAX package; their models are not ported yet
NOT_PORTED_TASKS = (
    "table-question-answering", "any-to-any", "image-classification",
    "zero-shot-image-classification", "automatic-speech-recognition", "image-text-to-text",
    "text2text-generation", "summarization", "image-to-text", "visual-question-answering",
    "zero-shot-object-detection", "video-classification", "depth-estimation",
    "image-segmentation", "object-detection", "audio-classification",
    "image-feature-extraction", "translation", "document-question-answering",
    "mask-generation", "keypoint-matching", "text-to-audio", "zero-shot-audio-classification",
)
TASK_ALIASES = {
    "text-to-speech": "text-to-audio",
    "sentiment-analysis": "text-classification",
    "ner": "token-classification",
    "vqa": "visual-question-answering",
}


def check_task(task: str):
    """(the task's name, its registry entry); raises for a task the JAX
    package registers but the port does not have yet, and for an unknown one."""
    task = TASK_ALIASES.get(task, task)
    if task in NOT_PORTED_TASKS:
        raise NotImplementedError(f"task {task!r} is not ported yet; the port has "
                                  f"{sorted(SUPPORTED_TASKS)}")
    if task not in SUPPORTED_TASKS:
        raise KeyError(f"Unknown task {task!r}. Available: {sorted(SUPPORTED_TASKS)}")
    return task, SUPPORTED_TASKS[task]


def pipeline(task: str, model=None, tokenizer=None, dtype="auto", device=None,
             **kwargs) -> Pipeline:
    """reference pipelines/__init__.py:387. ``model`` is a local checkpoint
    directory, loaded through the task's auto class onto ``device`` (the CUDA
    card unless told otherwise), or a model already loaded; the tokenizer
    comes from the same directory through ``AutoTokenizer`` unless given."""
    from ..models import auto
    from ..tokenization import AutoTokenizer

    task, (pipeline_cls, auto_name) = check_task(task)
    model_path = None
    if isinstance(model, str):
        model_path = model
        auto_cls = getattr(auto, auto_name)
        model = auto_cls.from_pretrained(model, dtype=dtype, device=resolve_device(device))
    if model is None:
        raise ValueError(f"pipeline({task!r}) needs a model directory or a loaded model")
    src = model_path or getattr(model.config, "_name_or_path", None)
    if tokenizer is None and src:
        tokenizer = AutoTokenizer.from_pretrained(src)
    return pipeline_cls(model=model, tokenizer=tokenizer, **kwargs)
