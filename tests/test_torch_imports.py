"""The PyTorch port stands alone: importing any of its modules loads no JAX
and nothing of the JAX package, nor the ``regex``, ``aiohttp`` or ``jinja2``
packages that the JAX package's tokenizer and server use, and its entry
points run on the CUDA card unless told otherwise.

One fresh interpreter (this test process has already imported both
packages) imports every module of the port in turn and records, after each,
which forbidden modules have been loaded; each module is then its own test
case. The port's name begins with ``transformers_tpu``, so the JAX package is
matched by its exact name or its ``transformers_tpu.`` prefix, never by a
bare string prefix. A second interpreter, in which those packages cannot be
imported at all, loads the tokenizer and the server modules and encodes and
decodes text; ``jinja2`` loads only when a chat template is applied.
"""

import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import transformers_tpu_torch as port
from torch_port_testing import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
MODULES = sorted(["transformers_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(port.__path__, "transformers_tpu_torch.")])

_CHILD = r"""
import importlib, json, sys

def forbidden():
    roots = ("jax", "jaxlib", "transformers_tpu", "regex", "aiohttp", "jinja2")
    return sorted(m for m in sys.modules
                  if m in roots or m.startswith(tuple(r + "." for r in roots)))

report = {}
for name in json.loads(sys.argv[1]):
    importlib.import_module(name)
    report[name] = forbidden()
print(json.dumps(report))
"""


@pytest.fixture(scope="module")
def import_report():
    proc = subprocess.run([sys.executable, "-c", _CHILD, json.dumps(MODULES)], cwd=REPO,
                          capture_output=True, text=True, timeout=120, check=True)
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", MODULES)
def test_module_imports_no_jax_and_no_jax_package(import_report, module):
    assert import_report[module] == []


def test_every_kernel_module_is_checked():
    for name in ("transformers_tpu_torch.ops.flash_attention",
                 "transformers_tpu_torch.ops.fused_decode",
                 "transformers_tpu_torch.ops.paged_attention",
                 "transformers_tpu_torch.ops.decode_attention",
                 "transformers_tpu_torch.generation.continuous_batching.model_runner",
                 "transformers_tpu_torch.ops.cuda_build",
                 "transformers_tpu_torch.models.llama.modeling_llama",
                 "transformers_tpu_torch.trainer",
                 "transformers_tpu_torch.generation.stopping_criteria",
                 "transformers_tpu_torch.generation.streamers",
                 "transformers_tpu_torch.ops.quantized_linear",
                 "transformers_tpu_torch.quantizers",
                 "transformers_tpu_torch.quantizers.base",
                 "transformers_tpu_torch.quantizers.weight_only",
                 "transformers_tpu_torch.quantizers.checkpoint_formats",
                 "transformers_tpu_torch.ops.moe",
                 *(f"transformers_tpu_torch.models.{family}.{kind}_{family}"
                   for family in ("mistral", "qwen2", "qwen3", "phi3", "gemma", "gemma2",
                                  "gemma3", "mixtral", "qwen2_moe", "qwen3_moe", "olmoe",
                                  "phimoe", "laguna", "gpt_oss", "olmo2", "minimax_m2",
                                  "ernie4_5", "ernie4_5_moe", "cohere", "cohere2",
                                  "cohere2_moe", "hunyuan_v1_dense", "hunyuan_v1_moe",
                                  "deepseek_v3", "deepseek_v2", "mistral4", "glm4_moe",
                                  "dots1", "solar_open")
                   for kind in ("configuration", "modeling"))):
        assert name in MODULES
    # the flash backward (K5 dQ, K4 dK/dV) lives in ops.flash_attention,
    # with a launch count per kernel
    from transformers_tpu_torch.ops import cuda_build, flash_attention as fa

    assert "flash_bwd" in cuda_build.KERNELS
    for wrapper in (fa.flash_attention, fa.flash_bwd_dq, fa.flash_bwd_dkv):
        assert isinstance(wrapper.launches, int)
    assert issubclass(fa.FlashAttentionFunction, torch.autograd.Function)
    # K7 (static-cache decode) is a mode of the fused decode library
    from transformers_tpu_torch.ops import decode_attention as da

    assert isinstance(da.decode_attention.launches, int)
    # K6 counts its split pass and its merge apart
    from transformers_tpu_torch.ops import paged_attention as pa
    from transformers_tpu_torch.ops.fused_decode import fused_decode_attention

    assert isinstance(pa.paged_decode_attention.launches, int)
    assert isinstance(pa.paged_decode_combine.launches, int)
    # the quantized product: Q1 from the codes, Q2's widening, one library
    from transformers_tpu_torch.ops import quantized_linear as ql

    assert "quantized_linear" in cuda_build.KERNELS
    assert isinstance(ql.quantized_matmul.launches, int)
    assert isinstance(ql.widen_codes.launches, int)
    # every wrapper is registered, so a captured graph's replays keep its count
    assert set(cuda_build._COUNTED) == {fa.flash_attention, fa.flash_bwd_dq, fa.flash_bwd_dkv,
                                        da.decode_attention, pa.paged_decode_attention,
                                        pa.paged_decode_combine, fused_decode_attention,
                                        ql.quantized_matmul, ql.widen_codes}


@pytest.mark.parametrize("entry", ["constructor", "from_pretrained", "auto_from_config"])
def test_entry_points_default_to_cuda_and_raise_without_a_card(entry, tmp_path, monkeypatch):
    config = port.LlamaConfig(vocab_size=32, hidden_size=64, intermediate_size=64,
                              num_hidden_layers=1, num_attention_heads=1, head_dim=64)
    if entry == "from_pretrained":
        port.LlamaForCausalLM(config, device="cpu").init_weights(0).save_pretrained(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "constructor":
            port.LlamaForCausalLM(config)
        elif entry == "from_pretrained":
            port.AutoModelForCausalLM.from_pretrained(tmp_path)
        else:
            port.AutoModelForCausalLM.from_config(config)


_BLOCKED = r"""
import json, sys
for name in ("jax", "jaxlib", "transformers_tpu", "regex", "aiohttp"):
    sys.modules[name] = None  # any import of them raises
import transformers_tpu_torch.cli.serving, transformers_tpu_torch.cli.chat
import transformers_tpu_torch.native
from transformers_tpu_torch import AutoTokenizer

tok = AutoTokenizer.from_pretrained("tests/fixtures/bpe48k")
tok.chat_template = "{% for m in messages %}{{ m['content'] }}{% endfor %}"
ids = tok.encode(sys.argv[1])
report = {"ids": ids, "text": tok.decode(ids), "native": tok.engine.model.uses_native,
          "jinja2_before": "jinja2" in sys.modules}
report["chat"] = tok.apply_chat_template([{"role": "user", "content": "hi"}], tokenize=False)
report["jinja2_after"] = "jinja2" in sys.modules
print(json.dumps(report))
"""


def test_tokenizer_and_server_need_no_regex_aiohttp_or_jax():
    text = "Tokenizer\x1c test: caf\u00e9 \u4e2d\u6587 \U0001f680 it's 123"
    proc = subprocess.run([sys.executable, "-c", _BLOCKED, text], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    tok = port.AutoTokenizer.from_pretrained(REPO / "tests" / "fixtures" / "bpe48k")
    assert report["ids"] == tok.encode(text) and report["text"] == text
    assert report["native"] and not report["jinja2_before"]
    assert report["chat"] == "hi" and report["jinja2_after"]
