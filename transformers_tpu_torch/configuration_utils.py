"""Model configuration base class.

Port of ``transformers_tpu/configuration_utils.py`` (reference
src/transformers/configuration_utils.py:146 ``PreTrainedConfig``): JSON
round-trip of ``config.json`` from and to local directories, kwarg overflow
into attributes, and attention-implementation selection.
"""

from __future__ import annotations

import copy
import json
import logging
import os
from typing import Any, Optional

logger = logging.getLogger(__name__)

CONFIG_NAME = "config.json"

__version__ = "0.1.0"


class PretrainedConfig:
    """Base config. Subclasses set ``model_type`` and declare defaults in __init__.

    Mirrors the reference's serialization contract (configuration_utils.py:146):
    - ``from_pretrained``/``save_pretrained`` round-trip ``config.json``
    - unknown kwargs become attributes (forward compat with hub checkpoints)
    - nested sub-configs (e.g. vision_config) instantiate recursively via
      ``sub_configs``.
    """

    model_type: str = ""
    # name -> config class (or "auto") for nested sub-configs
    sub_configs: dict[str, Any] = {}
    # Attribute aliases for cross-checkpoint compat (reference attribute_map)
    attribute_map: dict[str, str] = {}
    # Keys never serialized
    _non_serialized = ("_name_or_path",)

    def __setattr__(self, key, value):
        if key in type(self).attribute_map:
            key = type(self).attribute_map[key]
        super().__setattr__(key, value)

    def __getattr__(self, key):
        # Called only when normal lookup fails.
        attribute_map = super().__getattribute__("attribute_map")
        if key != "attribute_map" and key in attribute_map:
            return getattr(self, attribute_map[key])
        raise AttributeError(f"{type(self).__name__!r} object has no attribute {key!r}")

    def __init__(self, **kwargs):
        self._name_or_path = str(kwargs.pop("name_or_path", ""))
        self._attn_implementation = kwargs.pop("attn_implementation", None)
        # Common generation/serialization fields present in hub configs.
        self.output_hidden_states = kwargs.pop("output_hidden_states", False)
        self.output_attentions = kwargs.pop("output_attentions", False)
        self.return_dict = kwargs.pop("return_dict", True)
        self.is_encoder_decoder = kwargs.pop("is_encoder_decoder", False)
        self.is_decoder = kwargs.pop("is_decoder", False)
        self.tie_word_embeddings = kwargs.pop("tie_word_embeddings", True)
        self.chunk_size_feed_forward = kwargs.pop("chunk_size_feed_forward", 0)
        # Common task-head fields
        self.architectures = kwargs.pop("architectures", None)
        self.finetuning_task = kwargs.pop("finetuning_task", None)
        self.id2label = kwargs.pop("id2label", None)
        self.label2id = kwargs.pop("label2id", None)
        if self.id2label is not None:
            self.id2label = {int(k): v for k, v in self.id2label.items()}
        else:
            num_labels = kwargs.pop("num_labels", None)
            if num_labels is not None:
                self.id2label = {i: f"LABEL_{i}" for i in range(num_labels)}
                self.label2id = {v: k for k, v in self.id2label.items()}
        self.task_specific_params = kwargs.pop("task_specific_params", None)
        self.problem_type = kwargs.pop("problem_type", None)
        # Tokens
        self.tokenizer_class = kwargs.pop("tokenizer_class", None)
        self.prefix = kwargs.pop("prefix", None)
        self.bos_token_id = kwargs.pop("bos_token_id", None)
        self.pad_token_id = kwargs.pop("pad_token_id", None)
        self.eos_token_id = kwargs.pop("eos_token_id", None)
        self.sep_token_id = kwargs.pop("sep_token_id", None)
        self.decoder_start_token_id = kwargs.pop("decoder_start_token_id", None)
        # dtype the checkpoint was saved in (torch name, e.g. "bfloat16")
        self.dtype = kwargs.pop("dtype", kwargs.pop("torch_dtype", None))
        # Overflow: any remaining kwargs become attributes.
        for k, v in kwargs.items():
            try:
                setattr(self, k, v)
            except AttributeError as err:
                logger.error(f"Can't set {k} with value {v} for {self}")
                raise err

    @property
    def num_labels(self) -> int:
        return len(self.id2label) if self.id2label else 2

    @num_labels.setter
    def num_labels(self, value: int):
        if not self.__dict__.get("id2label") or len(self.id2label) != value:
            self.id2label = {i: f"LABEL_{i}" for i in range(value)}
            self.label2id = {v: k for k, v in self.id2label.items()}

    @property
    def name_or_path(self) -> str:
        return self._name_or_path

    def get_text_config(self, decoder: bool = False) -> "PretrainedConfig":
        """Return the text sub-config for composite models, else self.

        Reference parity: configuration_utils.py ``get_text_config``.
        """
        for name in ("text_config", "decoder"):
            sub = getattr(self, name, None)
            if isinstance(sub, PretrainedConfig):
                return sub
        return self

    # ------------------------------------------------------------------ IO
    @classmethod
    def from_pretrained(cls, pretrained_model_name_or_path, **kwargs) -> "PretrainedConfig":
        config_dict, kwargs = cls.get_config_dict(pretrained_model_name_or_path, **kwargs)
        return cls.from_dict(config_dict, **kwargs)

    @classmethod
    def get_config_dict(cls, pretrained_model_name_or_path, **kwargs) -> tuple[dict, dict]:
        config_file = kwargs.pop("config_file", CONFIG_NAME)
        resolved = os.path.join(str(pretrained_model_name_or_path), config_file)
        if not os.path.isfile(resolved):
            raise OSError(f"{resolved} not found: from_pretrained reads local directories only")
        with open(resolved, encoding="utf-8") as f:
            config_dict = json.load(f)
        config_dict["_name_or_path"] = str(pretrained_model_name_or_path)
        return config_dict, kwargs

    @classmethod
    def from_dict(cls, config_dict: dict, **kwargs) -> "PretrainedConfig":
        config_dict = dict(config_dict)
        return_unused = kwargs.pop("return_unused_kwargs", False)
        config_dict.pop("transformers_version", None)
        config_dict.pop("transformers_tpu_version", None)
        config_dict.pop("transformers_tpu_torch_version", None)
        # v5 checkpoints store rope under a single ``rope_parameters`` dict
        # (reference modeling_rope_utils.py RopeParameters) instead of
        # rope_theta + rope_scaling; translate on load. The per-layer-type
        # dict form ({"full_attention": {...}, ...}) is left for families
        # that consume it directly.
        rp = config_dict.get("rope_parameters")
        if (isinstance(rp, dict) and "rope_theta" in rp
                and "rope_theta" not in config_dict):
            rp = dict(rp)
            config_dict["rope_theta"] = rp.pop("rope_theta")
            rope_type = rp.get("rope_type", "default")
            if rope_type != "default" or len(rp) > 1:
                config_dict.setdefault("rope_scaling", rp)
        name_or_path = config_dict.pop("_name_or_path", "")
        # Instantiate nested sub-configs.
        for sub_name, sub_cls in cls.sub_configs.items():
            if sub_name in config_dict and isinstance(config_dict[sub_name], dict):
                sub_dict = config_dict[sub_name]
                if sub_cls == "auto" or sub_cls is None:
                    from .models.auto import AutoConfig

                    config_dict[sub_name] = AutoConfig.for_model_type(
                        sub_dict.get("model_type"), **{k: v for k, v in sub_dict.items() if k != "model_type"}
                    )
                else:
                    config_dict[sub_name] = sub_cls(**{k: v for k, v in sub_dict.items() if k != "model_type"})
        # kwargs override file values
        unused = {}
        for k, v in kwargs.items():
            if k in config_dict or hasattr(cls, k) or k in (
                "attn_implementation", "dtype", "tie_word_embeddings", "num_labels", "id2label", "label2id",
                "bos_token_id", "eos_token_id", "pad_token_id", "output_hidden_states", "output_attentions",
            ):
                config_dict[k] = v
            else:
                unused[k] = v
        config = cls(**config_dict)
        config._name_or_path = name_or_path
        if return_unused:
            return config, unused
        return config

    @classmethod
    def from_json_file(cls, json_file) -> "PretrainedConfig":
        with open(json_file, encoding="utf-8") as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> dict:
        output = copy.deepcopy(self.__dict__)
        output["model_type"] = self.model_type
        output["transformers_tpu_torch_version"] = __version__
        for k in self._non_serialized:
            output.pop(k, None)
        for k, v in list(output.items()):
            if isinstance(v, PretrainedConfig):
                output[k] = v.to_dict()
                output[k].pop("transformers_tpu_torch_version", None)
            if k.startswith("_") and k != "_attn_implementation":
                output.pop(k)
        if output.get("_attn_implementation") is None:
            output.pop("_attn_implementation", None)
        return output

    def to_json_string(self, use_diff: bool = True) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True, default=str) + "\n"

    def save_pretrained(self, save_directory, **kwargs) -> None:
        os.makedirs(save_directory, exist_ok=True)
        with open(os.path.join(save_directory, CONFIG_NAME), "w", encoding="utf-8") as f:
            f.write(self.to_json_string())

    def update(self, config_dict: dict) -> None:
        for k, v in config_dict.items():
            setattr(self, k, v)

    def __eq__(self, other):
        return isinstance(other, PretrainedConfig) and self.to_dict() == other.to_dict()

    def __repr__(self):
        return f"{type(self).__name__} {self.to_json_string()}"

    # ------------------------------------------------- attention dispatch
    @property
    def attn_implementation(self) -> str:
        """Selected attention kernel key (reference configuration_utils.py:415)."""
        return self._attn_implementation or "default"

    @attn_implementation.setter
    def attn_implementation(self, value: Optional[str]):
        self._attn_implementation = value
