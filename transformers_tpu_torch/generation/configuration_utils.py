"""GenerationConfig (port of transformers_tpu/generation/configuration_utils.py;
reference src/transformers/generation/configuration_utils.py:100).

``generation_config.json`` round-trip from and to local directories. Unknown
keys load without error and are preserved on save.
"""

from __future__ import annotations

import copy
import json
import logging
import os

logger = logging.getLogger(__name__)

GENERATION_CONFIG_NAME = "generation_config.json"


class GenerationConfig:
    def __init__(self, **kwargs):
        # Length
        self.max_length = kwargs.pop("max_length", 20)
        self.max_new_tokens = kwargs.pop("max_new_tokens", None)
        self.min_length = kwargs.pop("min_length", 0)
        self.min_new_tokens = kwargs.pop("min_new_tokens", None)
        # Strategy
        self.do_sample = kwargs.pop("do_sample", False)
        self.num_beams = kwargs.pop("num_beams", 1)
        self.num_return_sequences = kwargs.pop("num_return_sequences", 1)
        self.use_cache = kwargs.pop("use_cache", True)
        # Logits manipulation
        self.temperature = kwargs.pop("temperature", 1.0)
        self.top_k = kwargs.pop("top_k", 50)
        self.top_p = kwargs.pop("top_p", 1.0)
        self.min_p = kwargs.pop("min_p", None)
        self.typical_p = kwargs.pop("typical_p", 1.0)
        self.repetition_penalty = kwargs.pop("repetition_penalty", 1.0)
        self.no_repeat_ngram_size = kwargs.pop("no_repeat_ngram_size", 0)
        self.length_penalty = kwargs.pop("length_penalty", 1.0)
        self.early_stopping = kwargs.pop("early_stopping", False)
        self.suppress_tokens = kwargs.pop("suppress_tokens", None)
        self.begin_suppress_tokens = kwargs.pop("begin_suppress_tokens", None)
        self.forced_bos_token_id = kwargs.pop("forced_bos_token_id", None)
        self.forced_eos_token_id = kwargs.pop("forced_eos_token_id", None)
        self.forced_decoder_ids = kwargs.pop("forced_decoder_ids", None)
        # Special tokens
        self.pad_token_id = kwargs.pop("pad_token_id", None)
        self.bos_token_id = kwargs.pop("bos_token_id", None)
        self.eos_token_id = kwargs.pop("eos_token_id", None)
        self.decoder_start_token_id = kwargs.pop("decoder_start_token_id", None)
        # Cache selection (reference A.7: dynamic/static/quantized/...)
        self.cache_implementation = kwargs.pop("cache_implementation", None)
        # Output control
        self.output_scores = kwargs.pop("output_scores", False)
        self.return_dict_in_generate = kwargs.pop("return_dict_in_generate", False)
        # prompts are left-padded to a multiple of this length (shape buckets)
        self.prompt_pad_multiple = kwargs.pop("prompt_pad_multiple", 64)
        # when set, the cache and the captured decode step are sized for
        # max_new_tokens padded to this multiple, and the actual max_new_tokens
        # is only the loop's bound: lengths within one multiple share them
        self.decode_pad_multiple = kwargs.pop("decode_pad_multiple", None)
        kwargs.pop("transformers_version", None)
        kwargs.pop("transformers_tpu_version", None)
        self._extra = kwargs

    def __getattr__(self, name):
        extra = self.__dict__.get("_extra", {})
        if name in extra:
            return extra[name]
        raise AttributeError(name)

    @classmethod
    def from_model_config(cls, config) -> "GenerationConfig":
        return cls(
            pad_token_id=getattr(config, "pad_token_id", None),
            bos_token_id=getattr(config, "bos_token_id", None),
            eos_token_id=getattr(config, "eos_token_id", None),
            decoder_start_token_id=getattr(config, "decoder_start_token_id", None),
        )

    @classmethod
    def from_json_file(cls, path) -> "GenerationConfig":
        with open(path, encoding="utf-8") as f:
            return cls(**json.load(f))

    @classmethod
    def from_pretrained(cls, path_or_repo, **kwargs) -> "GenerationConfig":
        cfg = cls.from_json_file(os.path.join(str(path_or_repo), GENERATION_CONFIG_NAME))
        cfg.update(**kwargs)
        return cfg

    def to_dict(self) -> dict:
        d = {k: copy.deepcopy(v) for k, v in self.__dict__.items() if k != "_extra"}
        d.update(self._extra)
        return d

    def save_pretrained(self, save_directory, filename: str = GENERATION_CONFIG_NAME) -> None:
        os.makedirs(save_directory, exist_ok=True)
        d = {k: v for k, v in self.to_dict().items() if v is not None}
        with open(os.path.join(save_directory, filename), "w", encoding="utf-8") as f:
            json.dump(d, f, indent=2, sort_keys=True)

    def update(self, **kwargs) -> dict:
        unused = {}
        for k, v in kwargs.items():
            if hasattr(self, k) or k in self.__dict__:
                setattr(self, k, v)
            else:
                unused[k] = v
        return unused

    def copy(self) -> "GenerationConfig":
        return GenerationConfig(**self.to_dict())

    # Validation (reference configuration_utils.py:644): raise on outright
    # invalid values; warn once on flag combinations the selected mode will
    # silently ignore — hub checkpoints carry unsupported knobs all the time.
    def validate(self, strict: bool = False) -> None:
        if self.early_stopping not in (None, True, False, "never"):
            raise ValueError(
                f"`early_stopping` must be a boolean or 'never', but is {self.early_stopping}.")
        if self.max_new_tokens is not None and self.max_new_tokens <= 0:
            raise ValueError(
                f"`max_new_tokens` must be greater than 0, but is {self.max_new_tokens}.")
        valid_caches = (None, "static", "dynamic", "sliding_window", "hybrid",
                        "quantized", "offloaded_static", "paged")
        if self.cache_implementation not in valid_caches:
            raise ValueError(
                f"Invalid `cache_implementation` ({self.cache_implementation}). "
                f"Choose one of: {[c for c in valid_caches if c]}")

        minor: dict[str, str] = {}
        greedy_msg = ("`do_sample` is not set to `True`. However, `{flag}` is set to "
                      "`{value}` -- this flag is only used in sample-based generation "
                      "modes. You should set `do_sample=True` or unset `{flag}`.")
        if self.do_sample is not True:
            for flag, neutral in (("temperature", 1.0), ("top_p", 1.0),
                                  ("min_p", None), ("typical_p", 1.0),
                                  ("top_k", 50)):
                value = getattr(self, flag, None)
                if value is not None and value != neutral:
                    minor[flag] = greedy_msg.format(flag=flag, value=value)
        if not self.num_beams or self.num_beams == 1:
            beam_msg = ("`num_beams` is set to {n}. However, `{flag}` is set to "
                        "`{value}` -- this flag is only used in beam-based generation "
                        "modes. You should set `num_beams>1` or unset `{flag}`.")
            if self.early_stopping not in (None, False):
                minor["early_stopping"] = beam_msg.format(
                    n=self.num_beams, flag="early_stopping", value=self.early_stopping)
            if self.length_penalty is not None and self.length_penalty != 1.0:
                minor["length_penalty"] = beam_msg.format(
                    n=self.num_beams, flag="length_penalty", value=self.length_penalty)
            nrs = getattr(self, "num_return_sequences", None)
            if nrs and nrs > 1 and not self.do_sample:
                raise ValueError(
                    "Greedy methods (do_sample != True) without beam search do not "
                    f"support `num_return_sequences` > 1 (got {nrs}).")
        for flag, msg in minor.items():
            if strict:
                raise ValueError(f"strict validation: {msg}")
            logger.warning(msg)
