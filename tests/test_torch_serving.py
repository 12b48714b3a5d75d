"""The port's OpenAI-compatible server (``transformers_tpu_torch.cli.serving``)
on the CPU, through real HTTP.

A tiny Llama (2 layers, hidden 128, 4 query heads over 2 kv heads, head_dim
64, float32) whose vocabulary is a small byte-level BPE tokenizer's, written
as tokenizer.json here: every id the model can pick decodes to text, so every
id shows in the answers. Weights come from a numpy seed in the JAX layout and
are carried to the port by ``params_from_jax``. Each endpoint, streamed and
not, must answer with the text that the JAX tokenizer decodes from the JAX
package's greedy ``generate`` on the same prompt, and with its token counts;
a stream's deltas must add up to that text.

The hardening tests mirror tests/cli/test_serve_hardening.py: 429 past
``max_concurrency``, 504 at ``request_timeout``, and a client that goes away
has its request cancelled and its pages returned. The engine's steps are
slowed there so that a request outlasts the limits on any machine. One
subprocess starts ``python -m transformers_tpu_torch.cli serve --device cpu``
and reads ``/health``.
"""

import http.client
import json
import queue
import socket
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transformers_tpu as ttpu
from transformers_tpu.tokenization import AutoTokenizer as JaxAutoTokenizer
from transformers_tpu.tokenization.engine import bytes_to_unicode

import transformers_tpu_torch as port
from transformers_tpu_torch.cli.serving import OpenAIServer, ServeEngine
from torch_port_testing import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
MERGES = [("Ġ", "t"), ("h", "e"), ("Ġt", "he"), ("i", "n"), ("e", "r"), ("Ġ", "a"),
          ("o", "n"), ("Ġ", "s")]
VOCAB = len(bytes_to_unicode()) + len(MERGES)
CONFIG = dict(vocab_size=VOCAB, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, head_dim=64,
              max_position_embeddings=512, rms_norm_eps=1e-5, eos_token_id=None,
              pad_token_id=0)
ENGINE = dict(num_blocks=64, block_size=8, token_budget=16, max_batch=4, steps_per_sync=4)
NEW = 12
# (endpoint, what the request carries)
REQUESTS = {
    "completions": "The weather in the north is cold in winter",
    "chat": "Tell me about the sea and its tides",
    "responses": "Summer in the south: heat, été, 中文",
}


def write_tokenizer(directory: Path) -> None:
    """A byte-level BPE tokenizer.json: the 256 byte symbols and a few merges,
    no added tokens and no chat template (so chats take the fallback prompt)."""
    vocab = {c: i for i, c in enumerate(bytes_to_unicode().values())}
    for left, right in MERGES:
        vocab[left + right] = len(vocab)
    (directory / "tokenizer.json").write_text(json.dumps({
        "version": "1.0", "added_tokens": [], "normalizer": None,
        "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False, "use_regex": True},
        "post_processor": None, "decoder": {"type": "ByteLevel"},
        "model": {"type": "BPE", "vocab": vocab, "merges": [f"{a} {b}" for a, b in MERGES]}}))


def _numpy_params(jax_model, seed=0, std=0.1):
    rng = np.random.default_rng(seed)

    def draw(path, s):
        base = 1.0 if "norm" in jax.tree_util.keystr(path) else 0.0
        return jnp.asarray(base + std * rng.standard_normal(s.shape), jnp.float32)

    return jax.tree_util.tree_map_with_path(draw, jax_model.init_abstract())


def _prompt_text(endpoint: str) -> str:
    text = REQUESTS[endpoint]
    return text if endpoint == "completions" else f"user: {text}\nassistant:"


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(directory with tokenizer.json, the port's model, the expected
    {endpoint: (prompt ids, generated ids, text)} from the JAX package)."""
    d = tmp_path_factory.mktemp("serve_port")
    write_tokenizer(d)
    jax_model = ttpu.LlamaForCausalLM(ttpu.LlamaConfig(**CONFIG), dtype=jnp.float32)
    params = _numpy_params(jax_model)
    model = port.LlamaForCausalLM(port.LlamaConfig(**CONFIG), dtype=torch.float32, device="cpu")
    missing, unexpected = model.load_state_dict(
        port.params_from_jax(jax.tree.map(np.asarray, params)), strict=False)
    assert not missing and not unexpected
    jax_tok = JaxAutoTokenizer.from_pretrained(str(d))
    prompts = {e: jax_tok.encode(_prompt_text(e)) for e in REQUESTS}
    width = -(-max(map(len, prompts.values())) // 8) * 8
    ids = np.zeros((len(prompts), width), np.int64)
    mask = np.zeros((len(prompts), width), np.int32)
    for row, p in enumerate(prompts.values()):
        ids[row, width - len(p):] = p
        mask[row, width - len(p):] = 1
    out = np.asarray(jax_model.generate(params, input_ids=jnp.asarray(ids),
                                        attention_mask=jnp.asarray(mask), max_new_tokens=NEW,
                                        prompt_pad_multiple=8))
    expected = {}
    for row, (e, p) in enumerate(prompts.items()):
        gen = out[row, width:].tolist()
        expected[e] = (p, gen, jax_tok.decode(gen, skip_special_tokens=True))
    return d, model, expected


@pytest.fixture(scope="module")
def served(setup):
    d, model, expected = setup
    tok = port.AutoTokenizer.from_pretrained(d)
    engine = ServeEngine(model, tok, model_name="tiny", **ENGINE)
    server = OpenAIServer(engine, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield server.url, expected
    server.shutdown()
    server.server_close()
    engine.close()


def _slowed(engine: ServeEngine, seconds: float) -> None:
    step = engine.manager.engine.step

    def slow():
        time.sleep(seconds)
        return step()

    engine.manager.engine.step = slow


@pytest.fixture(scope="module")
def hardened(setup):
    """A server held to one request in flight and one second a request."""
    d, model, _ = setup
    engine = ServeEngine(model, port.AutoTokenizer.from_pretrained(d), model_name="tiny",
                         **ENGINE)
    _slowed(engine, 0.05)
    server = OpenAIServer(engine, port=0, max_concurrency=1, request_timeout=1.0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield server, engine
    server.shutdown()
    server.server_close()
    engine.close()


def _post(url, body, timeout=60):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _events(resp) -> list:
    """The JSON payloads of a server-sent event stream, up to ``[DONE]``."""
    out = []
    for line in resp:
        line = line.decode().rstrip("\n")
        if line.startswith("data: "):
            if line == "data: [DONE]":
                break
            out.append(json.loads(line[6:]))
    return out


def _body(endpoint: str, stream: bool) -> tuple:
    text = REQUESTS[endpoint]
    if endpoint == "completions":
        return "/v1/completions", {"prompt": text, "max_tokens": NEW, "temperature": 0,
                                   "stream": stream, "stream_options": {"include_usage": True}}
    if endpoint == "chat":
        return "/v1/chat/completions", {"messages": [{"role": "user", "content": text}],
                                        "max_tokens": NEW, "temperature": 0, "stream": stream,
                                        "stream_options": {"include_usage": True}}
    return "/v1/responses", {"input": text, "max_output_tokens": NEW, "temperature": 0,
                             "stream": stream}


@pytest.mark.parametrize("stream", [False, True], ids=["whole", "streamed"])
@pytest.mark.parametrize("endpoint", list(REQUESTS))
def test_endpoint_text_equals_jax_greedy_generate(served, endpoint, stream):
    url, expected = served
    prompt, generated, text = expected[endpoint]
    route, body = _body(endpoint, stream)
    with _post(url + route, body) as resp:
        assert resp.status == 200
        if not stream:
            out = json.loads(resp.read())
        else:
            assert resp.headers["Content-Type"] == "text/event-stream"
            events = _events(resp)
    if not stream:
        if endpoint == "responses":
            assert out["status"] == "completed"
            assert out["output"][0]["content"][0]["text"] == text
            assert out["usage"] == {"input_tokens": len(prompt), "output_tokens": NEW,
                                    "total_tokens": len(prompt) + NEW}
            return
        choice = out["choices"][0]
        got = choice["text"] if endpoint == "completions" else choice["message"]["content"]
        assert got == text and choice["finish_reason"] == "stop"
        assert out["usage"] == {"prompt_tokens": len(prompt), "completion_tokens": NEW,
                                "total_tokens": len(prompt) + NEW}
        return
    if endpoint == "responses":
        deltas = [e["delta"] for e in events if e["type"] == "response.output_text.delta"]
        done = events[-1]
        assert done["type"] == "response.completed"
        assert done["response"]["output"][0]["content"][0]["text"] == text
        assert done["response"]["usage"]["output_tokens"] == NEW
    else:
        key = "text" if endpoint == "completions" else "delta"
        chunks = [e for e in events if e["choices"]]
        deltas = [c["choices"][0][key] if key == "text" else c["choices"][0][key].get("content", "")
                  for c in chunks]
        deltas = [x for x in deltas if x]
        assert chunks[-1]["choices"][0]["finish_reason"] == "stop"
        assert events[-1]["usage"]["completion_tokens"] == NEW
        assert events[-1]["usage"]["prompt_tokens"] == len(prompt)
    assert "".join(deltas) == text
    assert len(deltas) >= 2  # delivered as generated, not all at the end


def test_health_and_models(served):
    url, _ = served
    with urllib.request.urlopen(url + "/health", timeout=30) as r:
        assert json.loads(r.read()) == {"status": "ok"}
    with urllib.request.urlopen(url + "/v1/models", timeout=30) as r:
        assert json.loads(r.read())["data"][0]["id"] == "tiny"
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(url + "/v1/nothing", timeout=30)
    assert err.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as err:  # a message without content
        _post(url + "/v1/chat/completions", {"messages": [{"role": "user"}]})
    assert err.value.code == 500 and "KeyError" in json.loads(err.value.read())["error"]["message"]
    with pytest.raises(urllib.error.HTTPError) as err:  # past the engine's context: failed, not lost
        _post(url + "/v1/completions", {"prompt": "hi", "max_tokens": 1000}, timeout=30)
    assert err.value.code == 500 and "exceeds max" in json.loads(err.value.read())["error"]["message"]


def _settled(engine: ServeEngine, free_before: int, timeout: float = 10.0) -> bool:
    """Whether the engine holds no request and all its pages are free again."""
    sched, bm = engine.manager.engine.scheduler, engine.manager.engine.bm
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if not sched.active and not sched.waiting and bm.num_free_blocks == free_before:
            return True
        time.sleep(0.05)
    return False


def test_request_timeout_504(hardened):
    server, engine = hardened
    free = engine.manager.engine.bm.num_free_blocks
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(server.url + "/v1/completions", {"prompt": "hello", "max_tokens": 100,
                                               "temperature": 0})
    assert err.value.code == 504
    assert json.loads(err.value.read())["error"]["type"] == "timeout"
    assert _settled(engine, free)


def test_backpressure_429(hardened):
    server, engine = hardened
    free = engine.manager.engine.bm.num_free_blocks
    results = queue.Queue()

    def slow():
        try:
            _post(server.url + "/v1/responses", {"input": "a", "max_output_tokens": 100})
        except urllib.error.HTTPError as e:
            results.put(e.code)

    t = threading.Thread(target=slow)
    t.start()
    time.sleep(0.3)
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(server.url + "/v1/completions", {"prompt": "b", "max_tokens": 2}, timeout=10)
    t.join(timeout=30)
    assert not t.is_alive()
    assert err.value.code == 429 and err.value.headers["Retry-After"] == "1"
    assert results.get_nowait() == 504
    assert _settled(engine, free)


@pytest.mark.parametrize("stream", [True, False], ids=["streamed", "whole"])
def test_client_that_goes_away_is_cancelled(hardened, stream, monkeypatch):
    """A stream closed after its first delta (the next write fails), and a
    request whose client closes while it waits (the socket shows it). No
    timeout here, so only the departure can cancel the request, which would
    otherwise run for 100 slowed steps."""
    server, engine = hardened
    monkeypatch.setattr(server, "request_timeout", None)
    free = engine.manager.engine.bm.num_free_blocks
    before = set(engine.manager.cancelled)
    host, port_number = server.server_address[:2]
    body = json.dumps({"messages": [{"role": "user", "content": "hi"}], "max_tokens": 100,
                       "temperature": 0, "stream": stream})
    if stream:
        conn = http.client.HTTPConnection(host, port_number, timeout=10)
        conn.request("POST", "/v1/chat/completions", body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        first = resp.fp.readline().decode()
        assert first.startswith("data: ")
        rid = json.loads(first[6:])["id"]
        resp.close()  # the response holds the socket open until it is closed too
        conn.close()
    else:
        sock = socket.create_connection((host, port_number), timeout=10)
        sock.sendall(f"POST /v1/chat/completions HTTP/1.0\r\nContent-Type: application/json\r\n"
                     f"Content-Length: {len(body)}\r\n\r\n{body}".encode())
        time.sleep(0.3)
        sock.close()
        rid = None
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and set(engine.manager.cancelled) == before:
        time.sleep(0.05)
    cancelled = set(engine.manager.cancelled) - before
    assert len(cancelled) == 1 and (rid is None or cancelled == {rid})
    assert _settled(engine, free)


def test_response_template_model_is_refused():
    tok = types.SimpleNamespace(response_template={"fields": {}})
    with pytest.raises(NotImplementedError, match="response template"):
        ServeEngine(types.SimpleNamespace(config=None), tok)


def test_cli_serve_on_cpu_answers_health(setup, tmp_path):
    d, model, _ = setup
    model.save_pretrained(tmp_path)
    (tmp_path / "tokenizer.json").write_text((d / "tokenizer.json").read_text())
    proc = subprocess.Popen([sys.executable, "-m", "transformers_tpu_torch.cli", "serve",
                             str(tmp_path), "--device", "cpu", "--port", "0"], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        lines = queue.Queue()
        threading.Thread(target=lambda: lines.put(proc.stdout.readline()), daemon=True).start()
        line = lines.get(timeout=60)
        assert line.startswith("serving ") and line.rstrip().endswith("(cpu)"), (
            line, proc.stderr.read() if proc.poll() is not None else "")
        url = line.split(" on ")[1].split()[0]
        with urllib.request.urlopen(url + "/health", timeout=30) as r:
            assert json.loads(r.read()) == {"status": "ok"}
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_chat_client_over_http(served, monkeypatch, capsys):
    """``cli chat <url>``: one user turn, then exit."""
    from transformers_tpu_torch.cli.chat import chat_over_http

    url, _ = served
    turns = iter([REQUESTS["chat"], "exit"])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(turns))
    chat_over_http(url)
    out = capsys.readouterr().out
    assert out.startswith(f"chatting with {url}")
