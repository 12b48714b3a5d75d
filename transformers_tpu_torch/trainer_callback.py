"""Trainer callback system: a copy of ``transformers_tpu/trainer_callback.py``
(reference src/transformers/trainer_callback.py: ``TrainerState`` :35,
``TrainerControl`` :234, event API :295-423). Host code only."""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional

import logging

logger = logging.getLogger(__name__)


@dataclass
class TrainerState:
    epoch: float = 0.0
    global_step: int = 0
    max_steps: int = 0
    num_train_epochs: int = 0
    log_history: list = field(default_factory=list)
    best_metric: Optional[float] = None
    best_model_checkpoint: Optional[str] = None
    is_world_process_zero: bool = True
    total_flos: float = 0.0
    num_input_tokens_seen: int = 0

    def save_to_json(self, json_path: str):
        with open(json_path, "w", encoding="utf-8") as f:
            json.dump(dataclasses.asdict(self), f, indent=2, sort_keys=True, default=str)

    @classmethod
    def load_from_json(cls, json_path: str) -> "TrainerState":
        with open(json_path, encoding="utf-8") as f:
            return cls(**json.load(f))


@dataclass
class TrainerControl:
    should_training_stop: bool = False
    should_epoch_stop: bool = False
    should_save: bool = False
    should_evaluate: bool = False
    should_log: bool = False

    def _new_step(self):
        self.should_save = False
        self.should_evaluate = False
        self.should_log = False


class TrainerCallback:
    """Subclass and override events (reference trainer_callback.py:295-423)."""

    def on_init_end(self, args, state, control, **kwargs):
        pass

    def on_train_begin(self, args, state, control, **kwargs):
        pass

    def on_train_end(self, args, state, control, **kwargs):
        pass

    def on_epoch_begin(self, args, state, control, **kwargs):
        pass

    def on_epoch_end(self, args, state, control, **kwargs):
        pass

    def on_step_begin(self, args, state, control, **kwargs):
        pass

    def on_step_end(self, args, state, control, **kwargs):
        pass

    def on_evaluate(self, args, state, control, metrics=None, **kwargs):
        pass

    def on_save(self, args, state, control, **kwargs):
        pass

    def on_log(self, args, state, control, logs=None, **kwargs):
        pass


class CallbackHandler(TrainerCallback):
    def __init__(self, callbacks, model, processing_class=None):
        self.callbacks = list(callbacks)
        self.model = model
        self.processing_class = processing_class

    def add_callback(self, callback):
        self.callbacks.append(callback() if isinstance(callback, type) else callback)

    def call_event(self, event: str, args, state, control, **kwargs):
        for callback in self.callbacks:
            result = getattr(callback, event)(args, state, control, model=self.model,
                                              processing_class=self.processing_class, **kwargs)
            if result is not None:
                control = result
        return control

    def __getattr__(self, name):
        if name.startswith("on_"):
            def call(args, state, control, **kwargs):
                return self.call_event(name, args, state, control, **kwargs)

            return call
        raise AttributeError(name)


class DefaultFlowCallback(TrainerCallback):
    """Log/eval/save cadence (reference trainer_callback.py DefaultFlowCallback)."""

    def on_step_end(self, args, state, control, **kwargs):
        log_on_steps = getattr(args, "logging_strategy", "steps") == "steps"
        if log_on_steps and args.logging_steps and state.global_step % args.logging_steps == 0:
            control.should_log = True
        if args.logging_first_step and state.global_step == 1:
            control.should_log = True
        if (args.eval_strategy == "steps" and args.eval_steps
                and state.global_step % args.eval_steps == 0
                and state.global_step >= getattr(args, "eval_delay", 0)):
            control.should_evaluate = True
        if args.save_strategy == "steps" and args.save_steps and state.global_step % args.save_steps == 0:
            control.should_save = True
        if state.global_step >= state.max_steps:
            control.should_training_stop = True
        return control

    def on_epoch_end(self, args, state, control, **kwargs):
        if getattr(args, "logging_strategy", "steps") == "epoch":
            control.should_log = True
        if args.eval_strategy == "epoch" and state.epoch >= getattr(args, "eval_delay", 0):
            control.should_evaluate = True
        if args.save_strategy == "epoch":
            control.should_save = True
        return control


class EarlyStoppingCallback(TrainerCallback):
    """Stop when the tracked metric fails to improve for ``patience`` evals
    (reference trainer_callback.py:585 EarlyStoppingCallback)."""

    def __init__(self, early_stopping_patience: int = 1,
                 early_stopping_threshold: float = 0.0):
        self.early_stopping_patience = early_stopping_patience
        self.early_stopping_threshold = early_stopping_threshold
        self.early_stopping_patience_counter = 0
        self._best = None

    def on_train_begin(self, args, state, control, **kwargs):
        if args.metric_for_best_model is None:
            raise ValueError("EarlyStoppingCallback requires metric_for_best_model")
        if args.eval_strategy == "no":
            raise ValueError("EarlyStoppingCallback requires eval_strategy != 'no'")

    def on_evaluate(self, args, state, control, metrics=None, **kwargs):
        key = args.metric_for_best_model
        if not key.startswith("eval_"):
            key = f"eval_{key}"
        value = (metrics or {}).get(key)
        if value is None:
            logger.warning(f"EarlyStopping: metric {key!r} missing from eval metrics")
            return control
        value = float(value)
        greater = bool(args.greater_is_better)
        improved = self._best is None or (
            value > self._best + self.early_stopping_threshold if greater
            else value < self._best - self.early_stopping_threshold)
        if improved:
            self._best = value
            self.early_stopping_patience_counter = 0
        else:
            self.early_stopping_patience_counter += 1
            if self.early_stopping_patience_counter >= self.early_stopping_patience:
                control.should_training_stop = True
        return control


class PrinterCallback(TrainerCallback):
    def on_log(self, args, state, control, logs=None, **kwargs):
        if logs:
            logger.info(str(logs))
