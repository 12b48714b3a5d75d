"""Trainer of the port: the training loop on one card.

Port of ``transformers_tpu/trainer.py`` (reference src/transformers/trainer.py:
``train`` :1347, ``training_step`` :1892, ``evaluate`` :2554,
``_save_checkpoint`` :3079). The model's parameters live on ``model.device``
and are updated in place; there is no mesh. One optimizer step is: for each
of ``gradient_accumulation_steps`` micro-batches a forward with labels and a
backward of the loss over GA (which equals the JAX step's mean over its
scan), then the global-norm clip, the optimizer step at ``lr =
schedule(step)``, and the gradients set to None.

The loss and grad norm stay on the device and are read back only at logging
steps, as the JAX loop reads them: a read per step would stall the card.

Checkpoints: the model as hub-layout safetensors (``save_pretrained``), the
optimizer as ``torch.save(optimizer.state_dict())`` under ``optimizer/``
(the JAX package's orbax has no torch counterpart), ``trainer_state.json``,
rotation and best-checkpoint tracking; resume fast-forwards the data.

Left out (they raise): NEFTune, reporters (``report_to``), hyperparameter
search.
"""

from __future__ import annotations

import logging
import math
import os
import shutil
import time
from typing import Callable, Optional

import numpy as np
import torch

from .core.loading import load_checkpoint_in_model, resolve_checkpoint_files
from .data.data_collator import default_data_collator
from .loss import for_causal_lm_loss
from .optimization import clip_by_global_norm_, create_optimizer, get_scheduler
from .trainer_callback import (
    CallbackHandler,
    DefaultFlowCallback,
    PrinterCallback,
    TrainerControl,
    TrainerState,
)
from .training_args import TrainingArguments

logger = logging.getLogger(__name__)

TRAINER_STATE_NAME = "trainer_state.json"
OPTIMIZER_DIR = "optimizer"
OPTIMIZER_NAME = "optimizer.pt"


class Trainer:
    def __init__(self, model, args: Optional[TrainingArguments] = None,
                 data_collator: Optional[Callable] = None, train_dataset=None,
                 eval_dataset=None, processing_class=None,
                 compute_metrics: Optional[Callable] = None, callbacks: Optional[list] = None,
                 compute_loss_func: Optional[Callable] = None):
        self.model = model
        self.args = args or TrainingArguments()
        if self.args.neftune_noise_alpha:
            raise NotImplementedError("NEFTune is not ported yet")
        if self.args.report_to not in (None, "none", [], ["none"]):
            raise NotImplementedError("reporting integrations are not ported yet")
        self.data_collator = data_collator or default_data_collator
        self.train_dataset = train_dataset
        self.eval_dataset = eval_dataset
        self.processing_class = processing_class
        self.compute_metrics = compute_metrics
        self.compute_loss_func = compute_loss_func
        self.device = model.device
        self.state = TrainerState()
        self.control = TrainerControl()
        self.callback_handler = CallbackHandler(
            [DefaultFlowCallback()] + (callbacks or []) + [PrinterCallback()],
            model, processing_class)
        self.optimizer = None
        self.lr_schedule = None
        self.callback_handler.call_event("on_init_end", self.args, self.state, self.control)

    # ------------------------------------------------------------ dataloader
    def get_train_dataloader(self, epoch: int = 0):
        return self._dataloader(self.train_dataset, self.args.train_batch_size, shuffle=True,
                                epoch=epoch, drop_last=self.args.dataloader_drop_last)

    def get_eval_dataloader(self, dataset=None):
        return self._dataloader(dataset or self.eval_dataset, self.args.eval_batch_size,
                                shuffle=False, drop_last=False)

    def _dataloader(self, dataset, batch_size: int, shuffle: bool, epoch: int = 0,
                    drop_last: bool = False):
        """The JAX Trainer's order: a numpy shuffle seeded by seed + epoch, so
        a resumed run (and the JAX package) sees the same batches."""
        n = len(dataset)
        idx = np.arange(n)
        if shuffle:
            seed = self.args.data_seed if self.args.data_seed is not None else self.args.seed
            np.random.default_rng(seed + epoch).shuffle(idx)
            if self.args.group_by_length:
                idx = self._group_by_length(dataset, idx, batch_size)
        end = (n // batch_size) * batch_size if drop_last else n
        for start in range(0, end, batch_size):
            yield self.data_collator([dataset[int(i)] for i in idx[start:start + batch_size]])

    def _group_by_length(self, dataset, idx: np.ndarray, batch_size: int) -> np.ndarray:
        """Sort by length, longest first, inside megabatches of 50 batches."""
        col = self.args.length_column_name

        def length_of(i):
            row = dataset[int(i)]
            if col in row:
                return int(np.asarray(row[col]))
            return len(np.asarray(row["input_ids"]))

        mega = batch_size * 50
        out = [sorted(idx[s:s + mega].tolist(), key=length_of, reverse=True)
               for s in range(0, len(idx), mega)]
        return np.asarray([i for c in out for i in c])

    def num_update_steps_per_epoch(self) -> int:
        steps = len(self.train_dataset) // self.args.train_batch_size
        return max(steps // self.args.gradient_accumulation_steps, 1)

    def _to_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    # --------------------------------------------------------------- setup
    def create_optimizer_and_scheduler(self, num_training_steps: int):
        args = self.args
        self.lr_schedule = get_scheduler(
            args.lr_scheduler_type, args.learning_rate,
            args.get_warmup_steps(num_training_steps), num_training_steps,
            args.lr_scheduler_kwargs)
        self.optimizer = create_optimizer(
            args.optim, self.model.parameters(), learning_rate=args.learning_rate,
            weight_decay=args.weight_decay, adam_beta1=args.adam_beta1,
            adam_beta2=args.adam_beta2, adam_epsilon=args.adam_epsilon)

    def compute_loss(self, batch: dict) -> torch.Tensor:
        smoothing = self.args.label_smoothing_factor
        if smoothing > 0 and self.compute_loss_func is None:
            return self._smoothed_loss(self.model, batch, smoothing)
        out = self.model(**batch)
        if self.compute_loss_func is not None:
            return self.compute_loss_func(out, batch)
        return out.loss

    @staticmethod
    def _smoothed_loss(model, batch, eps):
        """Label-smoothed CE over labels that are not -100, shifted by one
        unless the batch carries ``shift_labels`` (JAX ``Trainer._smoothed_loss``)."""
        batch = dict(batch)
        labels, shift_labels = batch.pop("labels", None), batch.pop("shift_labels", None)
        logits = model(**batch).logits
        return for_causal_lm_loss(logits, labels, logits.shape[-1], shift_labels=shift_labels,
                                  label_smoothing=eps)

    def training_step(self, micro_batches: list[dict]) -> tuple[torch.Tensor, torch.Tensor]:
        """One optimizer step over ``micro_batches``. Returns the mean loss and
        the gradients' global norm before clipping, both on the device."""
        ga = len(micro_batches)
        loss_sum = None
        for mb in micro_batches:
            loss = self.compute_loss(self._to_device(mb))
            (loss / ga).backward()
            loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
        params = [p for p in self.model.parameters() if p.grad is not None]
        grad_norm = clip_by_global_norm_([p.grad for p in params], self.args.max_grad_norm)
        lr = self.lr_schedule(self.state.global_step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        return loss_sum / ga, grad_norm

    # ---------------------------------------------------------------- train
    def train(self, resume_from_checkpoint: Optional[str] = None):
        args = self.args
        resume_from_checkpoint = resume_from_checkpoint or args.resume_from_checkpoint
        if args.eval_on_start and self.eval_dataset is not None:
            self.evaluate()
        self.model.gradient_checkpointing_enable(args.gradient_checkpointing)

        steps_per_epoch = self.num_update_steps_per_epoch()
        if args.max_steps > 0:
            max_steps = args.max_steps
            num_epochs = math.ceil(max_steps / steps_per_epoch)
        else:
            max_steps = int(steps_per_epoch * args.num_train_epochs)
            num_epochs = int(math.ceil(args.num_train_epochs))
        self.state.max_steps = max_steps
        self.state.num_train_epochs = num_epochs
        self.create_optimizer_and_scheduler(max_steps)

        start_step = 0
        if resume_from_checkpoint:
            self._load_checkpoint(resume_from_checkpoint)
            start_step = self.state.global_step
            # the loaded state carries the old run's horizon; this run's wins
            self.state.max_steps = max_steps
            self.state.num_train_epochs = num_epochs
            logger.info(f"Resuming from {resume_from_checkpoint} at step {start_step}")

        self.control = self.callback_handler.call_event(
            "on_train_begin", args, self.state, self.control)
        ga = args.gradient_accumulation_steps
        t0 = time.time()
        losses, grad_norm = [], None
        done = False
        seen_steps = 0  # optimizer steps met, those skipped on resume included
        for epoch in range(num_epochs):
            if done:
                break
            self.control = self.callback_handler.call_event(
                "on_epoch_begin", args, self.state, self.control)
            micro_batches = []
            for batch in self.get_train_dataloader(epoch):
                micro_batches.append(batch)
                if len(micro_batches) < ga:
                    continue
                seen_steps += 1
                if seen_steps <= start_step and not args.ignore_data_skip:
                    micro_batches = []  # dataloader fast-forward on resume
                    continue
                if args.include_num_input_tokens_seen:
                    self.state.num_input_tokens_seen += sum(
                        torch.as_tensor(mb["input_ids"]).numel() for mb in micro_batches
                        if "input_ids" in mb)
                self.control._new_step()
                self.control = self.callback_handler.call_event(
                    "on_step_begin", args, self.state, self.control)
                loss, grad_norm = self.training_step(micro_batches)
                micro_batches = []
                self.state.global_step += 1
                self.state.epoch = epoch + (self.state.global_step % max(steps_per_epoch, 1)) \
                    / max(steps_per_epoch, 1)
                losses.append(loss)
                self.control = self.callback_handler.call_event(
                    "on_step_end", args, self.state, self.control)
                if self.control.should_log:
                    mean_loss = float(np.mean([float(l) for l in losses]))
                    losses = []
                    logs = {"loss": round(mean_loss, 6),
                            "learning_rate": float(self.lr_schedule(self.state.global_step)),
                            "grad_norm": float(grad_norm), "epoch": round(self.state.epoch, 4),
                            "step": self.state.global_step}
                    self.state.log_history.append(logs)
                    self.control = self.callback_handler.call_event(
                        "on_log", args, self.state, self.control, logs=logs)
                if self.control.should_evaluate and self.eval_dataset is not None:
                    self.evaluate()
                if self.control.should_save:
                    self._save_checkpoint()
                    self._track_best_checkpoint()
                if self.state.global_step >= max_steps or self.control.should_training_stop:
                    done = True
                    break
            self.control = self.callback_handler.call_event(
                "on_epoch_end", args, self.state, self.control)
            if self.control.should_evaluate and self.eval_dataset is not None:
                self.evaluate()
                self.control.should_evaluate = False
            if self.control.should_save:
                self._save_checkpoint()
                self._track_best_checkpoint()
                self.control.should_save = False

        if args.load_best_model_at_end and self.state.best_model_checkpoint:
            logger.info(f"Loading best model from {self.state.best_model_checkpoint} "
                        f"({args.metric_for_best_model}={self.state.best_metric})")
            self._load_weights(self.state.best_model_checkpoint)
        train_time = time.time() - t0
        self.control = self.callback_handler.call_event(
            "on_train_end", args, self.state, self.control)
        return {"train_runtime": train_time,
                "train_steps_per_second": self.state.global_step / max(train_time, 1e-9)}

    # ------------------------------------------------------------- evaluate
    @torch.no_grad()
    def evaluate(self, eval_dataset=None, metric_key_prefix: str = "eval") -> dict:
        losses, all_logits, all_labels = [], [], []
        for batch in self.get_eval_dataloader(eval_dataset):
            out = self.model(**self._to_device(batch))
            losses.append(float(out.loss))
            if self.compute_metrics is not None:
                all_logits.append(out.logits.float().cpu().numpy())
                all_labels.append(np.asarray(batch["labels"]))
        metrics = {f"{metric_key_prefix}_loss": float(np.mean(losses)) if losses
                   else float("nan")}
        if self.compute_metrics is not None and all_logits:
            extra = self.compute_metrics((np.concatenate(all_logits), np.concatenate(all_labels)))
            metrics.update({f"{metric_key_prefix}_{k}": v for k, v in extra.items()})
        self.state.log_history.append(metrics)
        self.control = self.callback_handler.call_event(
            "on_evaluate", self.args, self.state, self.control, metrics=metrics)
        return metrics

    @torch.no_grad()
    def predict(self, test_dataset) -> tuple:
        """(logits as f32 numpy, labels or None) over ``test_dataset``."""
        outs, labels = [], []
        for batch in self.get_eval_dataloader(test_dataset):
            if "labels" in batch:
                labels.append(np.asarray(batch["labels"]))
            inputs = self._to_device({k: v for k, v in batch.items() if k != "labels"})
            outs.append(self.model(**inputs).logits.float().cpu().numpy())
        return np.concatenate(outs), (np.concatenate(labels) if labels else None)

    # ----------------------------------------------------------- checkpoints
    def save_model(self, output_dir: Optional[str] = None):
        output_dir = output_dir or self.args.output_dir
        self.model.save_pretrained(output_dir)
        if self.processing_class is not None and hasattr(self.processing_class, "save_pretrained"):
            self.processing_class.save_pretrained(output_dir)

    def _track_best_checkpoint(self):
        """Record best_metric / best_model_checkpoint after a save."""
        args = self.args
        if args.metric_for_best_model is None:
            return
        key = args.metric_for_best_model
        if not key.startswith("eval_"):
            key = f"eval_{key}"
        value = next((float(e[key]) for e in reversed(self.state.log_history) if key in e), None)
        if value is None:
            return
        best = self.state.best_metric
        if best is None or (value > best if args.greater_is_better else value < best):
            self.state.best_metric = value
            self.state.best_model_checkpoint = os.path.join(
                args.output_dir, f"checkpoint-{self.state.global_step}")

    def _save_checkpoint(self):
        ckpt_dir = os.path.join(self.args.output_dir, f"checkpoint-{self.state.global_step}")
        os.makedirs(ckpt_dir, exist_ok=True)
        self.save_model(ckpt_dir)
        if not self.args.save_only_model:
            opt_dir = os.path.join(ckpt_dir, OPTIMIZER_DIR)
            os.makedirs(opt_dir, exist_ok=True)
            torch.save(self.optimizer.state_dict(), os.path.join(opt_dir, OPTIMIZER_NAME))
        self.state.save_to_json(os.path.join(ckpt_dir, TRAINER_STATE_NAME))
        self.control = self.callback_handler.call_event(
            "on_save", self.args, self.state, self.control)
        self._rotate_checkpoints()

    def _rotate_checkpoints(self):
        limit = self.args.save_total_limit
        if not limit:
            return
        out = self.args.output_dir
        ckpts = sorted((d for d in os.listdir(out) if d.startswith("checkpoint-")),
                       key=lambda d: int(d.split("-")[-1]))
        best = os.path.basename(self.state.best_model_checkpoint or "")
        for stale in ckpts[:-limit]:
            if stale != best:  # never rotate the best checkpoint away
                shutil.rmtree(os.path.join(out, stale), ignore_errors=True)

    def _load_weights(self, ckpt_dir: str) -> None:
        """Checkpoint weights into the model's own parameters, in place, so
        the optimizer keeps holding them."""
        report = load_checkpoint_in_model(self.model, resolve_checkpoint_files(ckpt_dir))
        if report.missing_keys or report.unexpected_keys or report.mismatched_keys:
            raise ValueError(f"checkpoint {ckpt_dir} does not fit the model: {report}")

    def _load_checkpoint(self, ckpt_dir: str) -> None:
        self.state = TrainerState.load_from_json(os.path.join(ckpt_dir, TRAINER_STATE_NAME))
        self._load_weights(ckpt_dir)
        path = os.path.join(ckpt_dir, OPTIMIZER_DIR, OPTIMIZER_NAME)
        if not os.path.isfile(path):
            logger.warning("No optimizer state in checkpoint (save_only_model); "
                           "resuming with a fresh optimizer")
            return
        self.optimizer.load_state_dict(torch.load(path, map_location=self.device,
                                                  weights_only=True))
