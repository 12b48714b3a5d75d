"""Command line of the port (port of ``transformers_tpu/cli``):

    python -m transformers_tpu_torch.cli serve <model dir> [--device cuda|cpu] [--port N]
    python -m transformers_tpu_torch.cli chat <model dir | http(s) URL of a server>

Both run on the CUDA card unless ``--device cpu`` is given. ``serve`` has no
``--transcription-model``: the audio route is not ported yet.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser("transformers_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    serve_p = sub.add_parser("serve", help="OpenAI-compatible server (continuous batching)")
    serve_p.add_argument("model", help="local model directory")
    serve_p.add_argument("--host", default="127.0.0.1")
    serve_p.add_argument("--port", type=int, default=8000, help="0: any free port")
    serve_p.add_argument("--device", default="cuda")
    serve_p.add_argument("--num-blocks", type=int, default=512)
    serve_p.add_argument("--block-size", type=int, default=32)
    serve_p.add_argument("--max-batch", type=int, default=32)
    serve_p.add_argument("--token-budget", type=int, default=128)

    chat_p = sub.add_parser("chat", help="terminal chat client")
    chat_p.add_argument("target", help="local model directory, or http(s) URL of a server")
    chat_p.add_argument("--max-new-tokens", type=int, default=256)
    chat_p.add_argument("--device", default="cuda")

    args = parser.parse_args(argv)
    if args.command == "chat":
        from .chat import chat_local, chat_over_http

        if args.target.startswith("http"):
            chat_over_http(args.target)
        else:
            chat_local(args.target, max_new_tokens=args.max_new_tokens, device=args.device)
        return
    if args.command == "serve":
        from .serving import serve

        serve(args.model, host=args.host, port=args.port, device=args.device,
              num_blocks=args.num_blocks, block_size=args.block_size, max_batch=args.max_batch,
              token_budget=args.token_budget)
