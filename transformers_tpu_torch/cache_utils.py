"""Static KV cache in the bhsd layout.

Port of ``transformers_tpu/cache_utils.py`` (``StaticKVCache`` with
``layout="bhsd"``, ``layer_sliding_window``, ``cache_from_config``). Buffers
are preallocated per layer as ``[B, KVH, max_len, D]``: the per-(row, kv
head) slabs are contiguous, which is what the fused decode kernel streams.

Unlike the JAX cache, which is immutable and returns a new cache from every
update, this cache is updated IN PLACE: ``update`` writes into the
preallocated buffers, and the fused decode kernel writes slot ``pos`` itself.
That kernel reads ``pos`` from device memory: the cache owns the one-element
int32 slot tensor it reads (``slot_tensor``), set once per decode step.
Sliding-window layers keep a full-length buffer; the window is enforced by
the attention mask.
"""

from __future__ import annotations

from typing import Optional

import torch


class StaticKVCache:
    """Preallocated per-layer key and value buffers, [B, KVH, max_len, D] each."""

    def __init__(self, keys: list, values: list, layer_windows: tuple, max_len: int):
        self.keys = keys
        self.values = values
        self.layer_windows = layer_windows
        self.max_len = max_len
        self.slot = torch.zeros(1, dtype=torch.int32, device=keys[0].device if keys else None)
        self._slot_pos: Optional[int] = None  # the value ``slot`` holds

    def slot_tensor(self, pos: int) -> torch.Tensor:
        """The decode step's cache slot ``pos`` as the fused decode kernel reads
        it: ``slot``, a one-element int32 tensor on the cache's device. Every
        layer of a step asks for the same ``pos``; the first ask of a new one
        range-checks it and sets the tensor with one ``fill_``."""
        if pos != self._slot_pos:
            if not 0 <= pos < self.max_len:
                raise ValueError(f"cache slot {pos} outside [0, {self.max_len})")
            self.slot.fill_(pos)
            self._slot_pos = pos
        return self.slot

    def update(self, layer_idx: int, k: torch.Tensor, v: torch.Tensor, pos: int) -> None:
        """Write k/v given as [B, S, KVH, D] (the projection layout) at slots
        ``pos .. pos + S - 1``, in place."""
        s = k.shape[1]
        self.keys[layer_idx][:, :, pos:pos + s] = k.transpose(1, 2)
        self.values[layer_idx][:, :, pos:pos + s] = v.transpose(1, 2)

    def layer(self, layer_idx: int) -> tuple[torch.Tensor, torch.Tensor]:
        return self.keys[layer_idx], self.values[layer_idx]


def init_static_cache(*, num_layers: int, batch_size: int, max_len: int, num_kv_heads: int,
                      head_dim: int, dtype=torch.bfloat16, device=None,
                      layer_windows: Optional[tuple] = None) -> StaticKVCache:
    """An empty cache (reference StaticCache preallocation, cache_utils.py:1822)."""
    if layer_windows is None:
        layer_windows = (None,) * num_layers
    shape = (batch_size, num_kv_heads, max_len, head_dim)
    keys = [torch.zeros(shape, dtype=dtype, device=device) for _ in layer_windows]
    values = [torch.zeros(shape, dtype=dtype, device=device) for _ in layer_windows]
    return StaticKVCache(keys, values, tuple(layer_windows), max_len)


def layer_sliding_window(config, layer_idx: int) -> Optional[int]:
    """Per-layer effective sliding window (reference cache_utils.py:1694):

    - ``layer_types`` list: "sliding_attention" entries get the window.
    - Qwen2-style ``use_sliding_window`` + ``max_window_layers``: sliding only
      for layers >= max_window_layers.
    - plain ``sliding_window``: every layer (Mistral).
    """
    window = getattr(config, "sliding_window", None)
    if window is None:
        return None
    layer_types = getattr(config, "layer_types", None)
    if layer_types is not None:
        return window if layer_types[layer_idx] == "sliding_attention" else None
    if not getattr(config, "use_sliding_window", True):
        return None
    max_window_layers = getattr(config, "max_window_layers", None)
    if max_window_layers is not None and layer_idx < max_window_layers:
        return None
    return window


def cache_from_config(config, batch_size: int, max_len: int, dtype=torch.bfloat16,
                      device=None) -> StaticKVCache:
    """Cache geometry from a decoder config (per-layer windows included)."""
    text_config = config.get_text_config() if hasattr(config, "get_text_config") else config
    num_layers = text_config.num_hidden_layers
    num_kv = getattr(text_config, "num_key_value_heads", None) or text_config.num_attention_heads
    head_dim = getattr(text_config, "head_dim", None) or (
        text_config.hidden_size // text_config.num_attention_heads)
    return init_static_cache(
        num_layers=num_layers, batch_size=batch_size, max_len=max_len, num_kv_heads=num_kv,
        head_dim=head_dim, dtype=dtype, device=device,
        layer_windows=tuple(layer_sliding_window(text_config, i) for i in range(num_layers)))
