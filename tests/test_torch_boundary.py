"""The port's boundary: it never imports jax, runs on the CPU without it,
and its GPU entry points refuse to run without a GPU or a CUDA toolkit."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from ssi_tpu_torch import _build

REPO = Path(__file__).resolve().parent.parent


def test_port_sources_never_import_jax():
    """No port module and not chip_smoke.py imports jax, or the JAX package
    ``ssi_tpu`` (whose ``__init__`` may load jax)."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|ssi_tpu)(\.|\s|$)", re.MULTILINE)
    sources = [p for p in (REPO / "ssi_tpu_torch").rglob("*.py") if "_build" not in p.parts]  # skip build outputs
    offenders = [str(p) for p in sources if pattern.search(p.read_text())]
    offenders += [str(REPO / "chip_smoke.py")] if pattern.search((REPO / "chip_smoke.py").read_text()) else []
    assert offenders == []


_JAX_FREE_RUN = """
import sys
from ssi_tpu_torch.generate.engine import SamplingParams
from ssi_tpu_torch.generate.paged_engine import PagedDecodeEngine
from ssi_tpu_torch.models.configs import get_model_config
from ssi_tpu_torch.models.llama3 import init_params
import torch
cfg = get_model_config("tiny_test")
params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
eng = PagedDecodeEngine(params, cfg, pad_id=0, n_slots=2, page_size=8, prompt_bucket=8, max_context=32, chunk=2)
outs = eng.generate_batch([[1, 2, 3], [4, 5, 6, 7, 8, 9, 10, 11, 12]], SamplingParams(max_tokens=3))
assert [len(o["token_ids"]) for o in outs] == [3, 3], outs
# the verify step, the suffix prefill and chunked pieces (prefix cache on by default)
eng = PagedDecodeEngine(params, cfg, pad_id=0, n_slots=2, page_size=8, prompt_bucket=8, max_context=48, chunk=2,
                        speculate_k=2, prefill_chunk=8)
prompts = [list(range(1, 26)), list(range(1, 19)) + [7, 7, 7]]
outs = eng.generate_batch(prompts, SamplingParams(max_tokens=4))
assert [len(o["token_ids"]) for o in outs] == [4, 4], outs
assert eng.last_stats["verify_steps"] > 0 and eng.last_stats["prefill_pieces"] > 0, eng.last_stats
assert eng.generate_batch(prompts[:1], SamplingParams(max_tokens=4))[0]["token_ids"] == outs[0]["token_ids"]
assert eng.last_stats["cached_prompt_tokens"] > 0, eng.last_stats
from ssi_tpu_torch.train.lr_schedule import cosine_schedule_with_warmup
from ssi_tpu_torch.train.optimizer import AdamWConfig, init_opt_state
from ssi_tpu_torch.train.step import make_train_step
opt = AdamWConfig(lr=1e-3)
state = {"params": params, "opt_state": init_opt_state(params, opt), "step": 0}
step = make_train_step(cfg, opt, cosine_schedule_with_warmup(1e-3, 1, 4), clip_grad_norm=1.0, chunk_size=16)
tokens = torch.randint(1, cfg.vocab_size, (2, 2, 16), generator=torch.Generator().manual_seed(0), dtype=torch.int32)
state, metrics = step(state, tokens, tokens.clone())
assert state["step"] == 1 and bool(metrics["applied"]) and torch.isfinite(metrics["loss_sum"]), metrics
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "ssi_tpu"))
assert loaded == [], loaded
print("JAX_FREE_OK")
"""


def test_port_runs_the_engine_without_jax():
    """With the environment as it is (no switch that keeps jax out), importing
    the port, serving (with and without speculation, the prefix cache and
    chunked prefill) and taking a train step on the CPU load neither jax nor
    ``ssi_tpu``."""
    env = {k: v for k, v in os.environ.items() if k != "SSI_TPU_COMPILE_CACHE"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", _JAX_FREE_RUN], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX_FREE_OK" in proc.stdout


def test_chip_smoke_refuses_without_gpu(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; this checks the no-GPU refusal")
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_build_raises_clearly_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "_DEFAULT_CUDA_HOME", str(tmp_path / "default_cuda"))
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_library()


def test_launch_errors_raise_and_only_launches_count():
    _build.launch_counts.clear()
    with pytest.raises(RuntimeError, match="cudaError_t 9"):
        _build.check_launch("paged_attention_fused", 9)
    assert _build.launch_counts["paged_attention_fused"] == 0
    _build.check_launch("paged_attention_fused", 0)
    assert _build.launch_counts["paged_attention_fused"] == 1
    _build.launch_counts.clear()


def test_every_kernel_source_is_built_and_declared():
    """Each ``csrc/*.cu`` source is in the build, includes no PyTorch header
    (the sources have a plain C interface), and its C entry points are
    exactly the ones ``_build`` declares to ctypes."""
    sources = _build._sources()
    assert "paged_attention.cu" in [p.name for p in sources]  # both paged kernels' entry points
    entry = re.compile(r'extern "C" int (\w+)\(')
    found = set()
    for path in sources:
        text = path.read_text()
        assert not re.search(r'#include\s*[<"](torch|ATen|c10)/', text), path.name
        found |= set(entry.findall(text))
    assert found == set(_build._SIGNATURES)
