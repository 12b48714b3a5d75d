"""Terminal chat client (port of ``transformers_tpu/cli/chat.py``; reference
src/transformers/cli/chat.py ``transformers chat``): talks to a serve
endpoint over HTTP or runs a local model through the port's ``generate``."""

from __future__ import annotations

import json
import urllib.request


def chat_over_http(url: str, model_name: str = "model"):
    """Chat against an OpenAI-compatible endpoint (ours or anyone's)."""
    messages: list[dict] = []
    print(f"chatting with {url} — 'exit' to quit, 'clear' to reset")
    while True:
        try:
            user = input("> ").strip()
        except (EOFError, KeyboardInterrupt):
            break
        if user in ("exit", "quit"):
            break
        if user == "clear":
            messages = []
            continue
        if not user:
            continue
        messages.append({"role": "user", "content": user})
        req = urllib.request.Request(
            url.rstrip("/") + "/v1/chat/completions",
            data=json.dumps({"model": model_name, "messages": messages,
                             "max_tokens": 256, "temperature": 0}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req) as r:
            out = json.loads(r.read())
        reply = out["choices"][0]["message"]["content"]
        print(reply)
        messages.append({"role": "assistant", "content": reply})


def chat_local(model_path: str, max_new_tokens: int = 256, device="cuda"):
    """In-process chat (loads the model directly, on ``device``)."""
    import torch

    from ..models.auto import AutoModelForCausalLM
    from ..tokenization import AutoTokenizer

    model = AutoModelForCausalLM.from_pretrained(model_path, device=device)
    tok = AutoTokenizer.from_pretrained(model_path)
    messages: list[dict] = []
    print(f"chatting with {model_path} — 'exit' to quit, 'clear' to reset")
    while True:
        try:
            user = input("> ").strip()
        except (EOFError, KeyboardInterrupt):
            break
        if user in ("exit", "quit"):
            break
        if user == "clear":
            messages = []
            continue
        if not user:
            continue
        messages.append({"role": "user", "content": user})
        ids = tok.apply_chat_template(messages, add_generation_prompt=True)
        out = model.generate(torch.tensor([ids], device=model.device),
                             max_new_tokens=max_new_tokens)
        text = tok.decode(out[0, len(ids):].tolist(), skip_special_tokens=True)
        print(text)
        messages.append({"role": "assistant", "content": text})
