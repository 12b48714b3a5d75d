"""Static and int8 KV caches in the bhsd layout.

Port of ``transformers_tpu/cache_utils.py`` (``StaticKVCache`` and
``QuantizedKVCache`` with ``layout="bhsd"``, ``layer_sliding_window``,
``cache_from_config``). Buffers
are preallocated per layer as ``[B, KVH, max_len, D]``: the per-(row, kv
head) slabs are contiguous, which is what the fused decode kernel streams.

Unlike the JAX cache, which is immutable and returns a new cache from every
update, this cache is updated IN PLACE: ``update`` writes into the
preallocated buffers, and the fused decode kernel writes slot ``pos`` itself.
That kernel reads ``pos`` from device memory: the cache owns the one-element
int32 slot tensor it reads (``slot``). An eager caller passes the step's slot
as an int (``slot_tensor`` sets the tensor once per step); a decode loop on
the device sets it once (``device_slot``) and advances it at the end of each
step (``advance_slot``), so a captured CUDA graph of the step replays at the
slot the tensor holds.
Sliding-window layers keep a full-length buffer; the window is enforced by
the attention mask.
"""

from __future__ import annotations

from typing import Optional

import torch


class SlotCache:
    """Per-layer key and value buffers, [B, KVH, max_len, ...] each, and the
    one-element int32 slot tensor a decode step reads its cache slot from."""

    def __init__(self, keys: list, values: list, layer_windows: tuple, max_len: int):
        self.keys = keys
        self.values = values
        self.layer_windows = layer_windows
        self.max_len = max_len
        self.slot = torch.zeros(1, dtype=torch.int32, device=keys[0].device if keys else None)
        self._slot_pos: Optional[int] = None  # the value ``slot`` holds

    def slot_tensor(self, pos) -> torch.Tensor:
        """The decode step's cache slot ``pos`` as the fused decode kernel reads
        it: a one-element int32 tensor on the cache's device. A tensor ``pos``
        is that already (``slot`` itself, in a decode loop on the device) and
        is returned as it is: its value is never read here. For an int, every
        layer of a step asks for the same ``pos``; the first ask of a new one
        range-checks it and sets ``slot`` with one ``fill_``."""
        if isinstance(pos, torch.Tensor):
            return pos
        if pos != self._slot_pos:
            if not 0 <= pos < self.max_len:
                raise ValueError(f"cache slot {pos} outside [0, {self.max_len})")
            self.slot.fill_(pos)
            self._slot_pos = pos
        return self.slot

    def device_slot(self, pos: int) -> torch.Tensor:
        """``slot`` set to ``pos`` (range-checked) as the clock of a decode loop
        that advances it on the device (``advance_slot``); the host forgets
        the value, so a later ``slot_tensor(int)`` sets the tensor again."""
        if not 0 <= pos < self.max_len:
            raise ValueError(f"cache slot {pos} outside [0, {self.max_len})")
        self.slot.fill_(pos)
        self._slot_pos = None
        return self.slot

    def advance_slot(self) -> None:
        """``slot += 1`` on the device: the last op of a decode step."""
        self.slot.add_(1)
        self._slot_pos = None

    @staticmethod
    def _slot_index(pos, s: int) -> torch.Tensor:
        """The one slot of a one-token write at a tensor ``pos``, as an index."""
        if s != 1:
            raise ValueError("a tensor cache position writes one token")
        return pos.reshape(1).long()


class StaticKVCache(SlotCache):
    """Preallocated per-layer key and value buffers, [B, KVH, max_len, D] each."""

    def update(self, layer_idx: int, k: torch.Tensor, v: torch.Tensor, pos) -> None:
        """Write k/v given as [B, S, KVH, D] (the projection layout) at slots
        ``pos .. pos + S - 1``, in place. ``pos`` an int, or for one token a
        one-element tensor on the cache's device (not read back)."""
        s = k.shape[1]
        if isinstance(pos, torch.Tensor):
            idx = self._slot_index(pos, s)
            for buf, new in ((self.keys[layer_idx], k), (self.values[layer_idx], v)):
                buf.index_copy_(2, idx, new.transpose(1, 2).to(buf.dtype))
            return
        self.keys[layer_idx][:, :, pos:pos + s] = k.transpose(1, 2)
        self.values[layer_idx][:, :, pos:pos + s] = v.transpose(1, 2)

    def layer(self, layer_idx: int) -> tuple[torch.Tensor, torch.Tensor]:
        return self.keys[layer_idx], self.values[layer_idx]

    def reorder_(self, flat_idx: torch.Tensor) -> None:
        """Rows ``flat_idx`` [B] of every buffer, written back into the same
        storage (JAX ``beam_search.gather_cache``): a captured graph of a beam
        step replays over the same pointers. The gathered copy is a
        temporary, from the graph's pool inside a capture; advanced indexing
        gathers it at twice the rate of ``index_select`` on the H100."""
        for buf in self.keys + self.values:
            buf.copy_(buf[flat_idx])


class QuantizedKVCache(SlotCache):
    """int8 KV cache with per-(token, head) float32 scales (JAX
    ``QuantizedKVCache``, bhsd layout; reference cache_utils.py:698/:1877
    QuantizedCache): keys/values int8 [B, KVH, max_len, D], key_scales /
    value_scales [B, KVH, max_len, 1]. Each token's head vector is quantized
    symmetrically (max |x| / 127, floored at 1e-8) as it is written, in place
    and, for one token at a tensor slot, by ``index_copy_``, so a captured
    decode step replays at the slot the tensor holds. ``layer`` dequantizes to
    float32; attention over it takes the unfused route
    (``ops.attention.cached_attention_bhsd``), as in the JAX package."""

    def __init__(self, keys, values, key_scales, value_scales, layer_windows, max_len):
        super().__init__(keys, values, layer_windows, max_len)
        self.key_scales = key_scales
        self.value_scales = value_scales

    @staticmethod
    def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = x.float()
        scale = torch.clamp_min(x.abs().amax(dim=-1, keepdim=True) / 127.0, 1e-8)
        return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8), scale

    def update(self, layer_idx: int, k: torch.Tensor, v: torch.Tensor, pos) -> None:
        """Quantize and write k/v given as [B, S, KVH, D] at slots ``pos .. pos +
        S - 1``, in place (``pos`` as in ``StaticKVCache.update``)."""
        s = k.shape[1]
        writes = []
        for x, codes, scales in ((k, self.keys, self.key_scales),
                                 (v, self.values, self.value_scales)):
            q, sc = self._quantize(x)
            writes += [(codes[layer_idx], q), (scales[layer_idx], sc)]
        if isinstance(pos, torch.Tensor):
            idx = self._slot_index(pos, s)
            for buf, new in writes:
                buf.index_copy_(2, idx, new.transpose(1, 2))
            return
        for buf, new in writes:
            buf[:, :, pos:pos + s] = new.transpose(1, 2)

    def layer(self, layer_idx: int) -> tuple[torch.Tensor, torch.Tensor]:
        k = self.keys[layer_idx].float() * self.key_scales[layer_idx]
        v = self.values[layer_idx].float() * self.value_scales[layer_idx]
        return k, v


def init_quantized_cache(*, num_layers: int, batch_size: int, max_len: int, num_kv_heads: int,
                         head_dim: int, device=None,
                         layer_windows: Optional[tuple] = None) -> QuantizedKVCache:
    """An empty int8 cache (JAX ``init_quantized_cache``, bhsd)."""
    if layer_windows is None:
        layer_windows = (None,) * num_layers
    kv_shape = (batch_size, num_kv_heads, max_len, head_dim)
    sc_shape = (batch_size, num_kv_heads, max_len, 1)

    def make(shape, dtype):
        return [torch.zeros(shape, dtype=dtype, device=device) for _ in layer_windows]

    return QuantizedKVCache(make(kv_shape, torch.int8), make(kv_shape, torch.int8),
                            make(sc_shape, torch.float32), make(sc_shape, torch.float32),
                            tuple(layer_windows), max_len)


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
                      device=None, implementation: str = "static") -> SlotCache:
    """Cache geometry from a decoder config (per-layer windows included).
    ``implementation``: "quantized" builds the int8 cache; any other value the
    static one (the reference's ``cache_implementation`` vocabulary, as the JAX
    ``cache_from_config`` reads it), of ``dtype``."""
    text_config = config.get_text_config() if hasattr(config, "get_text_config") else config
    num_layers = text_config.num_hidden_layers
    num_kv = getattr(text_config, "num_key_value_heads", None) or text_config.num_attention_heads
    head_dim = getattr(text_config, "head_dim", None) or (
        text_config.hidden_size // text_config.num_attention_heads)
    geometry = dict(
        num_layers=num_layers, batch_size=batch_size, max_len=max_len, num_kv_heads=num_kv,
        head_dim=head_dim, device=device,
        layer_windows=tuple(layer_sliding_window(text_config, i) for i in range(num_layers)))
    if implementation == "quantized":
        return init_quantized_cache(**geometry)
    return init_static_cache(dtype=dtype, **geometry)
