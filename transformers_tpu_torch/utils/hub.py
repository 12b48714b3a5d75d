"""Checkpoint file names and their resolution in a local directory.

The port's counterpart of ``transformers_tpu/utils/hub.py``. Like the port's
``from_pretrained`` (modeling_utils.py), it reads local directories only: a
name that is not a directory raises ``OSError``; nothing is looked up in a
hub cache or downloaded.
"""

from __future__ import annotations

import os
from typing import Optional

TOKENIZER_FILE = "tokenizer.json"
TOKENIZER_CONFIG_FILE = "tokenizer_config.json"
SPECIAL_TOKENS_MAP_FILE = "special_tokens_map.json"
CHAT_TEMPLATE_FILE = "chat_template.jinja"


def cached_file(path_or_repo_id, filename: str, *, required: bool = True) -> Optional[str]:
    """``filename`` inside the local directory ``path_or_repo_id``; None when the
    directory lacks it and ``required`` is False."""
    directory = str(path_or_repo_id)
    if not os.path.isdir(directory):
        raise OSError(f"{directory!r} is not a local directory: the port reads checkpoints "
                      f"and tokenizers from local directories only (no hub download)")
    full = os.path.join(directory, filename)
    if os.path.isfile(full):
        return full
    if required:
        raise OSError(f"{directory} does not contain a file named {filename}.")
    return None
