"""OpenAI-compatible serving on the standard library's HTTP server.

Port of ``transformers_tpu/cli/serving.py`` (reference cli/serve.py:41 and
cli/serving/server.py:44). The JAX package serves on aiohttp; the port
serves on ``http.server.ThreadingHTTPServer``, one thread per connection, so
it needs no package outside the standard library. The endpoints and wire
format are the JAX server's: ``/v1/models``, ``/v1/chat/completions``,
``/v1/completions``, ``/v1/responses`` and ``/health``; with ``stream=true``
an answer is a stream of server-sent events (``data: {...}`` lines, then
``data: [DONE]``; the Responses API's typed ``event:`` lines), written as
the continuous-batching manager delivers tokens.

A handler thread submits its request to the ``ContinuousBatchingManager``
and blocks on the request's delivery queue. Hardening, as in the JAX server:

- backpressure: past ``max_concurrency`` requests in flight, 429 with
  ``Retry-After``;
- timeout: after ``request_timeout`` seconds the request is cancelled and
  504 returned (a stream ends instead);
- cancellation: a client that goes away (a write that fails, or a closed
  socket seen while waiting) has its request cancelled, which frees its pages.

Beyond the JAX server: ``/v1/completions`` streams and reports ``usage``; a
streamed chat or text completion ends with a ``usage`` chunk when the body
asks for one (``stream_options.include_usage``, as in OpenAI's API); and a
stream's held-back text is flushed when its request ends, so the deltas add
up to the text a request without ``stream`` gets.

Not ported yet: ``/v1/audio/transcriptions`` (it needs Whisper) and the
structured tool-call and reasoning deltas of a model with a response template
(the JAX ``utils/chat_parsing.py``); ``ServeEngine`` refuses such a model.
"""

from __future__ import annotations

import json
import logging
import queue
import select
import socket
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from ..generation.continuous_batching import ContinuousBatchingManager, RequestState
from .serving_utils import ModelManager, get_response_template

logger = logging.getLogger(__name__)

_LAST = ("finished", "failed", "cancelled")  # statuses that end a request's deliveries
_POLL_S = 0.25  # the longest a waiting handler goes without looking for a client that left


class ServeEngine:
    """Model + tokenizer + CB manager bundle."""

    def __init__(self, model, tokenizer, model_name: str = "model", **engine_kwargs):
        if get_response_template(tokenizer, model) is not None:
            raise NotImplementedError(
                f"{model_name} has a response template (structured tool calls and reasoning): "
                f"its parsing (utils/chat_parsing.py) is not ported yet, and its raw text is "
                f"not served as if it were plain")
        self.model = model
        self.tokenizer = tokenizer
        self.model_name = model_name
        self.manager = ContinuousBatchingManager(model, **engine_kwargs)
        self.manager.start()

    def close(self):
        self.manager.stop()

    def _eos_ids(self) -> tuple:
        eos = getattr(self.model.config, "eos_token_id", None)
        if eos is None and self.tokenizer is not None:
            eos = self.tokenizer.eos_token_id
        if eos is None:
            return ()
        return tuple(eos) if isinstance(eos, (list, tuple)) else (int(eos),)

    def submit_ids(self, prompt_ids: list[int], *, max_new_tokens: int,
                   temperature: float, seed: int = 0):
        req = RequestState(
            request_id=f"cmpl-{uuid.uuid4().hex[:20]}", prompt_ids=list(map(int, prompt_ids)),
            max_new_tokens=max_new_tokens, eos_token_ids=self._eos_ids(),
            temperature=temperature, seed=seed)
        return req.request_id, self.manager.submit(req)

    def chat_prompt_ids(self, messages: list[dict]) -> list[int]:
        if self.tokenizer.chat_template is not None:
            return self.tokenizer.apply_chat_template(messages, add_generation_prompt=True)
        text = "\n".join(f"{m['role']}: {m['content']}" for m in messages) + "\nassistant:"
        return self.tokenizer.encode(text)

    def decode(self, ids) -> str:
        return self.tokenizer.decode(list(map(int, ids)), skip_special_tokens=True)


class _TextStream:
    """A request's growing ids as text deltas (the plain-text case of the JAX
    ``_StreamParser``). A decode that ends in U+FFFD may be a character cut
    between tokens, so it is held back until later tokens complete it; the
    last call (``final``) flushes whatever is held."""

    def __init__(self, eng: ServeEngine):
        self.eng = eng
        self.sent = ""

    def delta(self, ids, final: bool = False) -> str:
        text = self.eng.decode(ids)
        if text.endswith("\ufffd") and not final:
            return ""
        delta, self.sent = text[len(self.sent):], text
        return delta


def _usage(prompt: int, completion: int, chat: bool = True) -> dict:
    if chat:
        return {"prompt_tokens": prompt, "completion_tokens": completion,
                "total_tokens": prompt + completion}
    return {"input_tokens": prompt, "output_tokens": completion,
            "total_tokens": prompt + completion}


def _temperature(body: dict) -> float:
    return float(body.get("temperature", 1.0) or 0.0)


class OpenAIServer(ThreadingHTTPServer):
    """The HTTP server: one handler thread per connection over one engine
    (or, with a ``ModelManager``, the engine a request's ``model`` names).
    Bound and listening once made (``port`` 0: any free port, read back from
    ``url``); it answers from ``serve_forever()``."""

    daemon_threads = True
    request_queue_size = 128  # a burst of connections waits in the backlog

    def __init__(self, engine: ServeEngine, host: str = "127.0.0.1", port: int = 8000, *,
                 manager: Optional[ModelManager] = None, max_concurrency: int = 64,
                 request_timeout: Optional[float] = None):
        self.engine = engine
        self.manager = manager
        self.max_concurrency = max_concurrency
        self.request_timeout = request_timeout
        self._inflight = 0
        self._lock = threading.Lock()
        super().__init__((host, port), _Handler)

    @property
    def url(self) -> str:
        host, port = self.server_address[:2]
        return f"http://{host}:{port}"

    def admit(self) -> bool:
        with self._lock:
            if self._inflight >= self.max_concurrency:
                return False
            self._inflight += 1
            return True

    def release(self) -> None:
        with self._lock:
            self._inflight -= 1

    def resolve_engine(self, body: dict) -> ServeEngine:
        """The preloaded model by default; with a ModelManager, whatever model
        the request names (reference model_manager.py)."""
        name = body.get("model")
        if self.manager is not None and name and name != self.engine.model_name:
            return self.manager.get(name)
        return self.engine


class _Handler(BaseHTTPRequestHandler):
    server: OpenAIServer
    # HTTP/1.0: one request per connection, and a stream ends when the server
    # closes it
    protocol_version = "HTTP/1.0"

    def log_message(self, format, *args):  # noqa: A002 - BaseHTTPRequestHandler's name
        logger.debug("%s %s", self.address_string(), format % args)

    # ---------------------------------------------------------------- replies
    def _json(self, status: int, obj: dict, headers: dict = None) -> None:
        data = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _timeout(self) -> None:
        self._json(504, {"error": {"message": "request timed out", "type": "timeout"}})

    def _failed(self, final) -> None:
        self._json(500, {"error": {"message": final.error or "failed"}})

    _streaming = False  # set once a stream's headers are out

    def _start_stream(self) -> None:
        self._streaming = True
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.end_headers()

    def _data(self, obj) -> None:
        self.wfile.write(f"data: {json.dumps(obj)}\n\n".encode())

    # --------------------------------------------------------------- requests
    def _client_gone(self) -> bool:
        """Whether the client closed its side (readable with nothing to read)."""
        try:
            readable, _, _ = select.select([self.connection], [], [], 0)
            return bool(readable) and self.connection.recv(1, socket.MSG_PEEK) == b""
        except OSError:
            return True

    def _follow(self, eng: ServeEngine, rid: str, q: queue.Queue,
                on_event: Optional[Callable] = None):
        """Wait for the request's deliveries, passing each to ``on_event``, and
        return the last; None when ``request_timeout`` ran out first. A
        timeout cancels the request, and so does a client that went away (a
        failed write in ``on_event`` or a closed socket), which re-raises."""
        timeout = self.server.request_timeout
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while True:
                if self._client_gone():
                    raise ConnectionResetError("the client closed the connection")
                wait = _POLL_S if deadline is None else min(_POLL_S, deadline - time.monotonic())
                if wait <= 0:
                    eng.manager.cancel(rid)
                    return None
                try:
                    ev = q.get(timeout=wait)
                except queue.Empty:
                    continue
                if on_event is not None:
                    on_event(ev)
                if ev.status in _LAST:
                    return ev
        except OSError:  # BrokenPipeError, ConnectionResetError
            eng.manager.cancel(rid)
            raise

    def _stream_text(self, eng: ServeEngine, rid: str, q: queue.Queue,
                     emit: Callable[[str], None]):
        """Follow a request, calling ``emit`` with each non-empty text delta,
        the held-back rest included when it ends; returns what ``_follow``
        returns."""
        text = _TextStream(eng)

        def on_event(ev):
            if ev.status != "failed":
                d = text.delta(ev.generated_ids, final=ev.status in _LAST)
                if d:
                    emit(d)

        return self._follow(eng, rid, q, on_event)

    # ----------------------------------------------------------------- routes
    def do_GET(self):
        if self.path == "/health":
            self._json(200, {"status": "ok"})
        elif self.path == "/v1/models":
            srv = self.server
            names = [srv.engine.model_name] + [
                n for n in (srv.manager.loaded() if srv.manager else []) if n != srv.engine.model_name]
            self._json(200, {"object": "list", "data": [
                {"id": n, "object": "model", "owned_by": "transformers_tpu_torch",
                 "created": int(time.time())} for n in names]})
        else:
            self._json(404, {"error": {"message": f"no route {self.path}"}})

    def do_POST(self):
        routes = {"/v1/chat/completions": self._chat_completions,
                  "/v1/completions": self._completions, "/v1/responses": self._responses}
        route = routes.get(self.path)
        if route is None:
            self._json(404, {"error": {"message": f"no route {self.path}"}})
            return
        try:
            body = json.loads(self.rfile.read(int(self.headers.get("Content-Length", 0))) or b"{}")
        except ValueError as exc:
            self._json(400, {"error": {"message": f"invalid JSON body: {exc}"}})
            return
        if not self.server.admit():
            self._json(429, {"error": {"message": "server overloaded, retry later",
                                       "type": "rate_limit_exceeded"}},
                       headers={"Retry-After": "1"})
            return
        try:
            route(body)
        except (BrokenPipeError, ConnectionResetError):
            logger.info("client %s went away; its request was cancelled", self.address_string())
            self.close_connection = True
        except Exception as exc:  # the server keeps running; the client hears of the failure
            logger.exception("%s failed", self.path)
            if not self._streaming:
                self._json(500, {"error": {"message": f"{type(exc).__name__}: {exc}"}})
        finally:
            self.server.release()

    def _chat_completions(self, body: dict):
        eng = self.server.resolve_engine(body)
        stream = bool(body.get("stream", False))
        max_new = int(body.get("max_tokens") or body.get("max_completion_tokens") or 128)
        temperature = _temperature(body)
        if not body.get("do_sample", True):
            temperature = 0.0
        prompt_ids = eng.chat_prompt_ids(body.get("messages", []))
        rid, q = eng.submit_ids(prompt_ids, max_new_tokens=max_new, temperature=temperature)
        created = int(time.time())
        head = {"id": rid, "created": created, "model": eng.model_name}
        if not stream:
            final = self._follow(eng, rid, q)
            if final is None:
                return self._timeout()
            if final.status == "failed":
                return self._failed(final)
            n = len(final.generated_ids)
            return self._json(200, {
                **head, "object": "chat.completion",
                "choices": [{"index": 0, "finish_reason": "stop", "message": {
                    "role": "assistant", "content": eng.decode(final.generated_ids)}}],
                "usage": _usage(len(prompt_ids), n)})

        def chunk(delta: dict, finish=None) -> dict:
            return {**head, "object": "chat.completion.chunk",
                    "choices": [{"index": 0, "delta": delta, "finish_reason": finish}]}

        self._start_stream()
        final = self._stream_text(eng, rid, q, lambda d: self._data(chunk({"content": d})))
        if final is None:
            self._data(chunk({}, "timeout"))
        else:
            self._data(chunk({}, "error" if final.status == "failed" else "stop"))
            if (body.get("stream_options") or {}).get("include_usage"):
                self._data({**head, "object": "chat.completion.chunk", "choices": [],
                            "usage": _usage(len(prompt_ids), len(final.generated_ids))})
        self.wfile.write(b"data: [DONE]\n\n")

    def _completions(self, body: dict):
        eng = self.server.engine
        prompt = body.get("prompt", "")
        if isinstance(prompt, list):
            prompt = prompt[0]
        stream = bool(body.get("stream", False))
        prompt_ids = eng.tokenizer.encode(prompt)
        rid, q = eng.submit_ids(prompt_ids, max_new_tokens=int(body.get("max_tokens", 16)),
                                temperature=_temperature(body))
        head = {"id": rid, "object": "text_completion", "created": int(time.time()),
                "model": eng.model_name}
        if not stream:
            final = self._follow(eng, rid, q)
            if final is None:
                return self._timeout()
            if final.status == "failed":
                return self._failed(final)
            return self._json(200, {
                **head, "choices": [{"index": 0, "text": eng.decode(final.generated_ids),
                                     "finish_reason": "stop"}],
                "usage": _usage(len(prompt_ids), len(final.generated_ids))})

        def chunk(text: str, finish=None) -> dict:
            return {**head, "choices": [{"index": 0, "text": text, "finish_reason": finish}]}

        self._start_stream()
        final = self._stream_text(eng, rid, q, lambda d: self._data(chunk(d)))
        if final is None:
            self._data(chunk("", "timeout"))
        else:
            self._data(chunk("", "error" if final.status == "failed" else "stop"))
            if (body.get("stream_options") or {}).get("include_usage"):
                self._data({**head, "choices": [],
                            "usage": _usage(len(prompt_ids), len(final.generated_ids))})
        self.wfile.write(b"data: [DONE]\n\n")

    def _responses(self, body: dict):
        """OpenAI Responses API (reference cli/serving/response.py): ``input``
        as a string or a message list; typed ``response.*`` events when
        streamed, else one response object."""
        eng = self.server.resolve_engine(body)
        raw_input = body.get("input", "")
        if isinstance(raw_input, str):
            messages = [{"role": "user", "content": raw_input}]
        else:
            messages = [{"role": m.get("role", "user"), "content": m.get("content", "")}
                        for m in raw_input]
        if body.get("instructions"):
            messages.insert(0, {"role": "system", "content": body["instructions"]})
        prompt_ids = eng.chat_prompt_ids(messages)
        rid = f"resp_{uuid.uuid4().hex[:20]}"
        cb_rid, q = eng.submit_ids(prompt_ids, max_new_tokens=int(body.get("max_output_tokens") or 128),
                                   temperature=_temperature(body))
        created = int(time.time())
        item = f"msg_{rid[5:]}"

        def response_obj(status: str, output_text: str, n_out: int) -> dict:
            message = {"id": item, "type": "message", "role": "assistant",
                       "status": "completed" if status == "completed" else "in_progress",
                       "content": [{"type": "output_text", "text": output_text,
                                    "annotations": []}]}
            return {"id": rid, "object": "response", "created_at": created, "status": status,
                    "model": eng.model_name, "output": [message],
                    "usage": _usage(len(prompt_ids), n_out, chat=False)}

        if not body.get("stream", False):
            final = self._follow(eng, cb_rid, q)
            if final is None:
                return self._timeout()
            if final.status == "failed":
                return self._failed(final)
            return self._json(200, response_obj("completed", eng.decode(final.generated_ids),
                                                len(final.generated_ids)))

        seq = 0

        def emit(etype: str, **payload):
            nonlocal seq
            seq += 1
            data = json.dumps({"type": etype, "sequence_number": seq, **payload})
            self.wfile.write(f"event: {etype}\ndata: {data}\n\n".encode())

        self._start_stream()
        emit("response.created", response=response_obj("in_progress", "", 0))
        parts: list[str] = []

        def delta(d: str):
            parts.append(d)
            emit("response.output_text.delta", item_id=item, output_index=0, content_index=0,
                 delta=d)

        final = self._stream_text(eng, cb_rid, q, delta)
        text = "".join(parts)
        n_out = 0 if final is None else len(final.generated_ids)
        if final is None or final.status == "failed":
            emit("response.failed", response=response_obj("failed", text, n_out))
            return
        emit("response.output_text.done", item_id=item, output_index=0, content_index=0,
             text=text)
        emit("response.completed", response=response_obj("completed", text, n_out))


def serve(model_path: str, host: str = "127.0.0.1", port: int = 8000, device="cuda",
          max_concurrency: int = 64, request_timeout: Optional[float] = None,
          **engine_kwargs):
    """Entry: load model + tokenizer from a local directory, run the server
    until interrupted (reference ``transformers serve``)."""
    from ..models.auto import AutoModelForCausalLM
    from ..tokenization import AutoTokenizer

    logger.info("loading %s on %s", model_path, device)
    model = AutoModelForCausalLM.from_pretrained(model_path, device=device)
    tokenizer = AutoTokenizer.from_pretrained(model_path)
    engine = ServeEngine(model, tokenizer, model_name=model_path, **engine_kwargs)
    try:
        server = OpenAIServer(engine, host, port, max_concurrency=max_concurrency,
                              request_timeout=request_timeout)
        print(f"serving {model_path} on {server.url} ({device})", flush=True)
        try:
            server.serve_forever()
        finally:
            server.server_close()
    finally:
        engine.close()
