"""Serving-side response templates + model lifecycle management.

Port of ``transformers_tpu/cli/serving_utils.py`` (reference
cli/serving/utils.py: response-template resolution, tool-call normalization;
cli/serving/model_manager.py: on-demand load, idle unload, LRU eviction).
Unloading closes the engine and drops the last reference to its model, whose
device memory PyTorch's allocator then reuses. The JAX module's
``parse_assistant_message`` parses a finished generation by a response
template (utils/chat_parsing.py), which the port does not have yet: the
server refuses a model that has a template (serving.py).
"""

from __future__ import annotations

import gc
import json
import logging
import threading
import time
import uuid
from dataclasses import dataclass
from typing import Any, Callable, Optional

logger = logging.getLogger(__name__)


# --------------------------------------------------------------------------
# response templates (declarative output parsing; the JAX utils/chat_parsing.py)
# --------------------------------------------------------------------------

# Fallbacks for tokenizers that don't ship a response_template. Delimiters are
# dictated by each model family's emission format (reference
# cli/serving/utils.py:94 keeps an equivalent table).
_QWEN_STYLE_TEMPLATE = {
    "defaults": {"role": "assistant"},
    "start_anchor": "<|im_start|>assistant\n",
    "fields": {
        "thinking": {"open": "<think>", "close": "</think>"},
        "tool_calls": {
            # leading \s* eats the separator newline between calls so it
            # can't open (then close-overwrite) an empty implicit content
            "open_pattern": r"\s*<tool_call>",
            "close": "</tool_call>",
            "repeats": True,
            "content": "json",
            "transform": {"type": "function", "function": "{content}"},
        },
        "content": {
            "close_pattern": r"\s*(?:<\|im_end\|>|<\|endoftext\|>)",
        },
    },
}

_RESPONSE_TEMPLATE_FALLBACKS: dict[str, dict] = {}
for _mt in ("qwen2", "qwen2_moe", "qwen2_vl", "qwen2_5_vl", "qwen3",
            "qwen3_moe", "qwen3_next", "qwen3_vl", "qwen3_vl_moe"):
    _RESPONSE_TEMPLATE_FALLBACKS[_mt] = _QWEN_STYLE_TEMPLATE


def get_response_template(tokenizer, model) -> Optional[dict]:
    """Tokenizer-shipped template first, model_type fallback second, else None
    (raw text passes through unparsed)."""
    tmpl = getattr(tokenizer, "response_template", None)
    if tmpl is not None:
        return tmpl
    model_type = getattr(getattr(model, "config", None), "model_type", None)
    return _RESPONSE_TEMPLATE_FALLBACKS.get(model_type)


@dataclass
class ToolCall:
    """One parsed tool call; ``arguments`` is always a JSON string (the
    OpenAI wire format), re-serialized from the parser's dict."""

    name: str
    arguments: str

    def as_openai(self, index: int = 0) -> dict:
        return {
            "id": f"call_{uuid.uuid4().hex[:16]}",
            "type": "function",
            "index": index,
            "function": {"name": self.name, "arguments": self.arguments},
        }


def normalize_tool_call(value: dict) -> ToolCall:
    fn = value.get("function", value) if isinstance(value, dict) else {}
    args = fn.get("arguments", {})
    if not isinstance(args, str):
        args = json.dumps(args)
    return ToolCall(name=fn.get("name", ""), arguments=args)


# --------------------------------------------------------------------------
# model manager: on-demand load + idle unload + LRU cap
# --------------------------------------------------------------------------

class ManagedModel:
    """An engine plus its idle timer. ``touch()`` on every request; after
    ``timeout_seconds`` of silence the unload callback fires (reference
    TimedModel, cli/serving/model_manager.py:43)."""

    def __init__(self, name: str, engine: Any, timeout_seconds: int,
                 on_unload: Callable[[str], None]):
        self.name = name
        self.engine = engine
        self.timeout_seconds = timeout_seconds
        self._on_unload = on_unload
        self.last_used = time.monotonic()
        self._timer: Optional[threading.Timer] = None
        self.touch()

    def touch(self) -> None:
        self.last_used = time.monotonic()
        if self._timer is not None:
            self._timer.cancel()
        if self.timeout_seconds > 0:
            self._timer = threading.Timer(self.timeout_seconds, self._expire)
            self._timer.daemon = True
            self._timer.start()

    def _expire(self) -> None:
        logger.info(f"{self.name}: idle for {self.timeout_seconds}s, unloading")
        self._on_unload(self.name)

    def close(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
        close = getattr(self.engine, "close", None)
        if close is not None:
            close()
        self.engine = None
        gc.collect()


class ModelManager:
    """Keeps up to ``max_models`` engines alive, loading on first request and
    evicting least-recently-used (or idle-timed-out) ones. ``loader`` maps a
    model name to an engine object (anything with an optional ``close()``)."""

    def __init__(self, loader: Callable[[str], Any], *, max_models: int = 2,
                 model_timeout: int = 300):
        self._loader = loader
        self._max_models = max(1, max_models)
        self._timeout = model_timeout
        self._lock = threading.Lock()
        self._models: dict[str, ManagedModel] = {}

    def get(self, name: str):
        """Fetch (loading if needed) the engine for ``name``."""
        with self._lock:
            entry = self._models.get(name)
            if entry is not None:
                entry.touch()
                return entry.engine
        # load outside the lock: loads are slow and must not serialize serving
        engine = self._loader(name)
        with self._lock:
            if name in self._models:  # lost a load race; keep the first
                engine_close = getattr(engine, "close", None)
                if engine_close is not None:
                    engine_close()
                entry = self._models[name]
                entry.touch()
                return entry.engine
            self._models[name] = ManagedModel(name, engine, self._timeout, self.unload)
            self._evict_over_cap()
            return self._models[name].engine

    def _evict_over_cap(self) -> None:
        # caller holds the lock
        while len(self._models) > self._max_models:
            victim = min(self._models.values(), key=lambda m: m.last_used)
            logger.info(f"model cache over cap; evicting {victim.name}")
            self._models.pop(victim.name).close()

    def unload(self, name: str) -> None:
        with self._lock:
            entry = self._models.pop(name, None)
        if entry is not None:
            entry.close()

    def loaded(self) -> list[str]:
        with self._lock:
            return sorted(self._models)

    def close(self) -> None:
        with self._lock:
            entries, self._models = list(self._models.values()), {}
        for e in entries:
            e.close()
