"""Streamers (port of ``transformers_tpu/generation/streamers.py``; reference
src/transformers/generation/streamers.py:28-314).

Host consumers of the tokens ``generate(streamer=...)`` produces. A streamer
takes ``generate()`` onto its streaming route, which reads every step back:
the prompt arrives first (``put`` of the left-padded ids [B, S]), then one
chunk [B, 1] per generated token, then ``end()``. Values arrive as numpy
arrays.
"""

from __future__ import annotations

import queue
from typing import Optional

import numpy as np


class BaseStreamer:
    def put(self, value):
        raise NotImplementedError

    def end(self):
        raise NotImplementedError


class TextStreamer(BaseStreamer):
    """Decodes tokens to stdout as they arrive (reference streamers.py:42).
    ``tokenizer`` is any object with ``decode(ids, **kw) -> str``."""

    def __init__(self, tokenizer, skip_prompt: bool = False, **decode_kwargs):
        self.tokenizer = tokenizer
        self.skip_prompt = skip_prompt
        self.decode_kwargs = decode_kwargs
        self.token_cache: list[int] = []
        self.print_len = 0
        self.next_tokens_are_prompt = True

    def put(self, value):
        value = np.asarray(value)
        if value.ndim > 1 and value.shape[0] > 1:
            raise ValueError("TextStreamer only supports batch size 1")
        if value.ndim > 1:
            value = value[0]
        if self.skip_prompt and self.next_tokens_are_prompt:
            self.next_tokens_are_prompt = False
            return
        self.token_cache.extend(int(t) for t in value.reshape(-1))
        text = self.tokenizer.decode(self.token_cache, **self.decode_kwargs)
        if text.endswith("\n"):
            printable = text[self.print_len:]
            self.token_cache = []
            self.print_len = 0
        elif len(text) > 0 and text[-1] == "�":
            printable = ""  # an unfinished multi-byte character: wait for more tokens
        else:
            printable = text[self.print_len:]
            self.print_len += len(printable)
        self.on_finalized_text(printable)

    def end(self):
        if self.token_cache:
            text = self.tokenizer.decode(self.token_cache, **self.decode_kwargs)
            printable = text[self.print_len:]
            self.token_cache = []
            self.print_len = 0
        else:
            printable = ""
        self.next_tokens_are_prompt = True
        self.on_finalized_text(printable, stream_end=True)

    def on_finalized_text(self, text: str, stream_end: bool = False):
        print(text, flush=True, end="" if not stream_end else None)


class TextIteratorStreamer(TextStreamer):
    """Iterator over the decoded text, for a consumer in another thread
    (reference streamers.py:157)."""

    def __init__(self, tokenizer, skip_prompt: bool = False, timeout: Optional[float] = None,
                 **decode_kwargs):
        super().__init__(tokenizer, skip_prompt, **decode_kwargs)
        self.text_queue: queue.Queue = queue.Queue()
        self.stop_signal = None
        self.timeout = timeout

    def on_finalized_text(self, text: str, stream_end: bool = False):
        self.text_queue.put(text, timeout=self.timeout)
        if stream_end:
            self.text_queue.put(self.stop_signal, timeout=self.timeout)

    def __iter__(self):
        return self

    def __next__(self):
        value = self.text_queue.get(timeout=self.timeout)
        if value == self.stop_signal:
            raise StopIteration()
        return value


class AsyncTextIteratorStreamer(TextStreamer):
    """Async iterator over the decoded text (reference streamers.py:226):
    generation runs in a worker thread and consumers ``async for`` the text.
    Construct it inside a running event loop."""

    def __init__(self, tokenizer, skip_prompt: bool = False,
                 timeout: Optional[float] = None, **decode_kwargs):
        super().__init__(tokenizer, skip_prompt, **decode_kwargs)
        import asyncio

        self._asyncio = asyncio
        self.text_queue: "asyncio.Queue" = asyncio.Queue()
        self.stop_signal = None
        self.timeout = timeout
        self.loop = asyncio.get_running_loop()

    def on_finalized_text(self, text: str, stream_end: bool = False):
        self.loop.call_soon_threadsafe(self.text_queue.put_nowait, text)
        if stream_end:
            self.loop.call_soon_threadsafe(self.text_queue.put_nowait, self.stop_signal)

    def __aiter__(self):
        return self

    async def __anext__(self):
        try:
            value = await self._asyncio.wait_for(self.text_queue.get(), timeout=self.timeout)
        except self._asyncio.TimeoutError:
            raise TimeoutError() from None
        if value == self.stop_signal:
            raise StopAsyncIteration()
        return value
