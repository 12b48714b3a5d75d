"""TrainingArguments of the port (``transformers_tpu/training_args.py``;
reference src/transformers/training_args.py:174).

The fields the Trainer reads, under the same names and with the same
defaults. The port trains on one card: a ``ParallelismConfig`` of more than
one device, ``fsdp`` and ``deepspeed`` raise, and ``train_batch_size`` is the
per-device batch itself (the JAX one multiplies it by the mesh's device
count). ``bf16``/``fp16`` cast nothing: the model's ``dtype`` and
``param_dtype`` decide; ``fp16`` maps to ``bf16`` with a warning, as in JAX.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from dataclasses import dataclass
from typing import Optional

logger = logging.getLogger(__name__)


@dataclass
class ParallelismConfig:
    """Device-mesh axis sizes (JAX ``ParallelismConfig``). Only a total of
    one device is accepted here."""

    dp_size: int = 1
    fsdp_size: int = 1
    tp_size: int = 1
    cp_size: int = 1
    sp_size: int = 1

    def __post_init__(self):
        if self.total() > 1:
            raise ValueError("the port trains on one card; multi-device training is a later PR")

    def total(self) -> int:
        return self.dp_size * self.fsdp_size * self.tp_size * self.cp_size * self.sp_size


@dataclass
class TrainingArguments:
    output_dir: str = "trainer_output"

    # batch / steps
    per_device_train_batch_size: int = 8
    per_device_eval_batch_size: int = 8
    gradient_accumulation_steps: int = 1
    num_train_epochs: float = 3.0
    max_steps: int = -1

    # optimizer
    learning_rate: float = 5e-5
    weight_decay: float = 0.0
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    optim: str = "adamw"

    # scheduler
    lr_scheduler_type: str = "linear"
    lr_scheduler_kwargs: Optional[dict] = None
    warmup_steps: int = 0
    warmup_ratio: float = 0.0

    # loss shaping
    label_smoothing_factor: float = 0.0
    label_smoothing: Optional[float] = None  # alias of label_smoothing_factor

    # memory
    gradient_checkpointing: bool = False

    # logging / eval / save
    logging_strategy: str = "steps"  # no | steps | epoch
    logging_steps: int = 500
    logging_first_step: bool = False
    eval_strategy: str = "no"  # no | steps | epoch
    eval_steps: Optional[int] = None
    eval_delay: float = 0
    eval_on_start: bool = False
    save_strategy: str = "steps"  # no | steps | epoch
    save_steps: int = 500
    save_total_limit: Optional[int] = None
    save_only_model: bool = False
    load_best_model_at_end: bool = False
    metric_for_best_model: Optional[str] = None
    greater_is_better: Optional[bool] = None
    report_to: Optional[list] = None

    # numerics
    seed: int = 42
    data_seed: Optional[int] = None
    bf16: bool = False
    fp16: bool = False

    # parallelism and the options this port leaves out (they raise)
    parallelism_config: Optional[ParallelismConfig] = None
    fsdp: str = ""
    deepspeed: Optional[str] = None
    neftune_noise_alpha: Optional[float] = None

    # dataloader
    dataloader_drop_last: bool = True
    group_by_length: bool = False
    length_column_name: str = "length"

    # misc
    resume_from_checkpoint: Optional[str] = None
    ignore_data_skip: bool = False
    include_num_input_tokens_seen: bool = False

    def __post_init__(self):
        if self.deepspeed or self.fsdp:
            raise ValueError("the port trains on one card; deepspeed and fsdp are not supported")
        if isinstance(self.parallelism_config, dict):
            self.parallelism_config = ParallelismConfig(**self.parallelism_config)
        if self.fp16:
            logger.warning("fp16 requested; the port computes in bfloat16 as the JAX package "
                           "does — using bf16")
            self.bf16, self.fp16 = True, False
        if self.label_smoothing is not None:
            self.label_smoothing_factor = self.label_smoothing
        if self.load_best_model_at_end:
            if self.metric_for_best_model is None:
                self.metric_for_best_model = "loss"
            if self.eval_strategy == "no":
                raise ValueError(
                    "load_best_model_at_end requires eval_strategy of 'steps' or 'epoch'")
        if self.greater_is_better is None and self.metric_for_best_model is not None:
            self.greater_is_better = not self.metric_for_best_model.rstrip().endswith("loss")
        for name, value in (("logging_strategy", self.logging_strategy),
                            ("eval_strategy", self.eval_strategy),
                            ("save_strategy", self.save_strategy)):
            if value not in ("no", "steps", "epoch"):
                raise ValueError(f"{name} must be one of no|steps|epoch, got {value!r}")

    @property
    def train_batch_size(self) -> int:
        """Rows per micro-batch: one card, so the per-device batch."""
        return self.per_device_train_batch_size

    @property
    def eval_batch_size(self) -> int:
        return self.per_device_eval_batch_size

    def get_warmup_steps(self, num_training_steps: int) -> int:
        if self.warmup_steps > 0:
            return self.warmup_steps
        return int(num_training_steps * self.warmup_ratio)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json_string(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True, default=str)
