"""The port's boundary: it never imports jax, runs on the CPU without it,
and its GPU entry points (the engine, the HTTP server, generation, extension
and training) refuse to run without a GPU or a CUDA toolkit."""

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


# host libraries the card's machine lacks (jax, tiktoken, yaml, safetensors,
# msgpack) or may lack (datasets, ml_dtypes, jinja2, regex, transformers)
_NOT_ON_THE_CARD = ("jax", "jaxlib", "ssi_tpu", "yaml", "tiktoken", "safetensors", "msgpack", "datasets", "ml_dtypes",
                    "jinja2", "regex", "transformers")


def test_port_sources_import_no_library_missing_on_the_card():
    """No port source imports a library of ``_NOT_ON_THE_CARD``, with one
    optional import: ``generate/templates.py`` hands a path template with
    Jinja syntax other than ``{{ name }}`` to jinja2, inside the function
    that renders it, when jinja2 imports (the shipped templates never need
    it: the ``generate_sample`` case below runs with jinja2 blocked)."""
    names = "|".join(_NOT_ON_THE_CARD)
    pattern = re.compile(rf"^(\s*)(import|from)\s+({names})(\.|\s|$)", re.MULTILINE)
    sources = [p for p in (REPO / "ssi_tpu_torch").rglob("*.py") if "_build" not in p.parts] + [REPO / "chip_smoke.py"]
    optional = (REPO / "ssi_tpu_torch" / "generate" / "templates.py", "jinja2")
    offenders = []
    for path in sources:
        for m in pattern.finditer(path.read_text()):
            if (path, m.group(3)) == optional and m.group(1).strip("\n"):  # indented: inside a function
                continue
            offenders.append(f"{path}: {m.group(0).strip()}")
    assert offenders == []
    assert len(pattern.findall(optional[0].read_text())) == 1


_CLI_RUN = """
import runpy, sys
sys.argv = ["ssi_tpu_torch.cli.generate", *sys.argv[1:]]
runpy.run_module("ssi_tpu_torch.cli.generate", run_name="__main__")
loaded = sorted(m for m in sys.modules if m.split(".")[0] in NAMES)
assert loaded == [], loaded
print("CLI_OK")
"""


def _cli_overrides(model_dir: Path, split: Path, out: Path) -> list[str]:
    return [f"model={model_dir}", f"experiments_root_dir={model_dir.parent}",
            f"tokenizer.path={model_dir / 'original' / 'tokenizer.model'}", "model_config=tiny_test",
            "speech.n_dsus=16", "data=sft/mls-hubert_large_ll60k-layer_22", "data.test.dataset.source=json",
            f"+data.test.dataset.data_files={split}", "data.test.dataset.split=train", "gen.split=test",
            "batch_size=2", "sampling_params.max_tokens=4", "dtype=fp32", f"gen.output_dir={out}"]


def test_generation_cli_runs_without_the_card_libraries(tmp_path):
    """``python -m ssi_tpu_torch.cli.generate ... +device=cpu`` on the tiny
    checkpoint loads none of the libraries the card's machine lacks; without
    ``+device=cpu`` and with no CUDA device it refuses (no CPU fallback)."""
    import json

    import torch

    from tests import helpers

    model_dir = helpers.make_tiny_hf_checkpoint(tmp_path / "step_0")
    split = tmp_path / "test.jsonl"
    split.write_text("".join(json.dumps(r) + "\n" for r in helpers.synthetic_sft_rows(3)))
    env = {k: v for k, v in os.environ.items() if k != "SSI_TPU_COMPILE_CACHE"}
    env["PYTHONPATH"] = str(REPO)
    code = _CLI_RUN.replace("NAMES", repr(_NOT_ON_THE_CARD))
    args = _cli_overrides(model_dir, split, tmp_path / "gens")
    proc = subprocess.run([sys.executable, "-c", code, *args, "+device=cpu"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "CLI_OK" in proc.stdout
    assert len((tmp_path / "gens" / "json" / "test" / "generations.jsonl").read_text().splitlines()) == 3
    if torch.cuda.is_available():
        return
    proc = subprocess.run([sys.executable, "-m", "ssi_tpu_torch.cli.generate", *_cli_overrides(
        model_dir, split, tmp_path / "refused")], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "+device=cpu" in proc.stderr
    assert not (tmp_path / "refused").exists()


_TRAIN_CLIS_RUN = """
import sys
from ssi_tpu_torch.cli import extend_llama3_2, train_cpt, train_sft
base, ext, out, sft, cpt = sys.argv[1:6]
device = sys.argv[6:]
extend_llama3_2.main(extend_llama3_2.parse_args(["--n_new_dsus", "16", "--input_dir", base, "--output_dir", ext,
                                                 "--model-config", "tiny_test", *(["--device", "cpu"] if device else [])]))
common = ["model_config=tiny_test", "speech.n_dsus=16", f"checkpointer.checkpoint_dir={ext}",
          f"tokenizer.path={ext}/original/tokenizer.model", "max_steps=1", "save_steps=1", "eval_steps=1",
          "wandb.enabled=false", "hydra/job_logging=none", *device]
for split in ("train", "dev"):
    common += [f"data.{split}.dataset.source=json", f"data.{split}.dataset.split=train",
               f"data.{split}.dataloader.batch_size=2"]
train_sft.main(["data=sft/mls-hubert_large_ll60k-layer_22", *common, f"checkpointer.output_dir={out}/sft",
                f"+data.train.dataset.data_files={sft}", f"+data.dev.dataset.data_files={sft}",
                "tokenizer.max_seq_len=384"])
train_cpt.main(["data=cpt/mls-hubert_large_ll60k-layer_22", *common, f"checkpointer.output_dir={out}/cpt",
                f"+data.train.dataset.data_files={cpt}", f"+data.dev.dataset.data_files={cpt}",
                "gradient_accumulation_steps=2", "tokenizer.max_seq_len=256"])
loaded = sorted(m for m in sys.modules if m.split(".")[0] in NAMES)
assert loaded == [], loaded
print("TRAIN_CLIS_OK")
"""


def test_training_clis_run_without_the_card_libraries(tmp_path):
    """The extension, SFT and CPT CLIs (``conf/sft.yaml`` and ``conf/cpt.yaml``
    as they stand, with ``remat: save_qkv_mlp``) each run once on the CPU with
    ``+device=cpu`` on a tiny base checkpoint, one optimizer step each, and load
    none of the libraries the card's machine may lack; without ``+device=cpu``
    and with no CUDA device the first of them refuses before writing anything."""
    import json

    import torch

    from ssi_tpu_torch.checkpoint.convert import internal_to_hf
    from ssi_tpu_torch.checkpoint.safetensors_io import save_file
    from ssi_tpu_torch.models.configs import get_model_config
    from ssi_tpu_torch.models.llama3 import init_params
    from tests import helpers

    cfg = get_model_config("tiny_test")  # no DSUs: the base
    base = tmp_path / "base"
    (base / "original").mkdir(parents=True)
    save_file(internal_to_hf(init_params(cfg, seed=3, dtype=torch.float32, device="cpu"), cfg),
              base / "model.safetensors", metadata={"format": "pt"})
    (base / "config.json").write_text(json.dumps({"vocab_size": cfg.vocab_size, "bos_token_id": 128_000,
                                                  "eos_token_id": 128_001}))
    (base / "generation_config.json").write_text(json.dumps({"bos_token_id": 128_000, "eos_token_id": 128_001}))
    (base / "original" / "params.json").write_text(json.dumps({"vocab_size": cfg.vocab_size}))
    helpers.write_tiny_tokenizer(base / "original" / "tokenizer.model")
    sft, cpt = tmp_path / "sft.jsonl", tmp_path / "cpt.jsonl"
    sft.write_text("".join(json.dumps(r) + "\n" for r in helpers.synthetic_sft_rows(8)))
    cpt.write_text("".join(json.dumps(r) + "\n" for r in helpers.synthetic_cpt_rows(4)))
    env = {k: v for k, v in os.environ.items() if k != "SSI_TPU_COMPILE_CACHE"}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    code = _TRAIN_CLIS_RUN.replace("NAMES", repr(_NOT_ON_THE_CARD))
    paths = [str(p) for p in (base, tmp_path / "ext", tmp_path / "out", sft, cpt)]
    proc = subprocess.run([sys.executable, "-c", code, *paths, "+device=cpu"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "TRAIN_CLIS_OK" in proc.stdout
    for kind in ("sft", "cpt"):
        assert (tmp_path / "out" / kind / "step_1" / "model.safetensors.index.json").is_file()
        assert (tmp_path / "out" / kind / "training_state.msgpack").is_file()
    if torch.cuda.is_available():
        return
    paths[1] = str(tmp_path / "refused")
    proc = subprocess.run([sys.executable, "-c", code, *paths], cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0 and "--device cpu" in proc.stderr
    assert not (tmp_path / "refused").exists()
    proc = subprocess.run([sys.executable, "-m", "ssi_tpu_torch.cli.train_sft", "data=sft/mls-hubert_large_ll60k-layer_22",
                           f"checkpointer.output_dir={tmp_path / 'refused'}"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "+device=cpu" in proc.stderr
    assert not (tmp_path / "refused").exists()


# imported by Python at start-up (``sitecustomize``) in every process of the run
# below, the drive's stage subprocesses included: an import of a blocked
# library fails as it would on a machine without it
_BLOCKER = """
import sys

BLOCKED = {names}


class _Blocked:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ModuleNotFoundError(f"No module named {{name!r}} (blocked for this test)", name=name)
        return None


sys.meta_path.insert(0, _Blocked())
"""
_WER_BLOCKED = ("jax", "jaxlib", "ssi_tpu", "transformers", "regex", "safetensors", "yaml", "tiktoken", "msgpack")


def test_wer_clis_and_drive_run_with_the_host_libraries_blocked(tmp_path):
    """The evaluation layer (``eval/``), ``python -m ssi_tpu_torch.cli.wer_parity``,
    ``python -m ssi_tpu_torch.cli.wer`` and the port's WER drive (``--smoke
    --device cpu`` at ``tiny_test`` width: every stage's CLI) run with jax,
    ``ssi_tpu``, transformers, regex, safetensors, pyyaml, tiktoken and msgpack
    blocked from import in every process."""
    import json

    block = tmp_path / "block"
    block.mkdir()
    (block / "sitecustomize.py").write_text(_BLOCKER.format(names=repr(set(_WER_BLOCKED))))
    env = {k: v for k, v in os.environ.items() if k != "SSI_TPU_COMPILE_CACHE"}
    env.update(PYTHONPATH=f"{block}{os.pathsep}{REPO}", OMP_NUM_THREADS="2")

    def run(*args, ok=True):
        proc = subprocess.run([sys.executable, *map(str, args)], cwd=tmp_path, env=env, capture_output=True,
                              text=True, timeout=600)
        assert (proc.returncode == 0) == ok, proc.stdout[-3000:] + proc.stderr[-3000:]
        return proc

    assert "blocked for this test" in run("-c", "import yaml", ok=False).stderr  # the blocker is in place
    gen_dir = tmp_path / "gens" / "mls-x" / "test"
    gen_dir.mkdir(parents=True)
    (gen_dir / "generations.jsonl").write_text("".join(
        json.dumps({"outputs": [{"text": t}]}) + "\n" for t in ("the colour of one", "twenty dollars")))
    refs = tmp_path / "refs.jsonl"
    refs.write_text("".join(json.dumps({"transcript": t}) + "\n" for t in ("the color of 1", "$20")))
    run("-m", "ssi_tpu_torch.cli.wer_parity", "--skip-generate", gen_dir, "--refs-jsonl", refs)
    assert json.loads((gen_dir / "wer_parity.json").read_text())["wer"] == 0.0
    assert "A12" in run("-m", "ssi_tpu_torch.cli.wer", gen_dir / "generations.jsonl", ok=False).stderr
    art = tmp_path / "art"
    run("-m", "ssi_tpu_torch.wer_drive", "--workdir", tmp_path / "wd", "--artifacts-dir", art, "--smoke",
        "--device", "cpu", "--model-config", "tiny_test", "--max-seq-len", "512", "--batch-size", "4",
        "--grad-accum", "1", "--decode-slots", "8")
    summary = json.loads((art / "summary.json").read_text())
    assert {"wer_bf16", "wer_int8", "spelling_map_sha256"} <= set(summary)


_SERVE_RUN = """
import runpy, sys
sys.argv = ["ssi_tpu_torch.cli.serve", *sys.argv[1:]]
runpy.run_module("ssi_tpu_torch.cli.serve", run_name="__main__")
loaded = sorted(m for m in sys.modules if m.split(".")[0] in NAMES)
assert loaded == [], loaded
print("SERVE_OK", flush=True)
"""


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve_args(model_dir: Path, port: int) -> list[str]:
    return [f"model={model_dir}", "model_config=tiny_test", "speech.n_dsus=16",
            f"tokenizer.path={model_dir / 'original' / 'tokenizer.model'}", "dtype=fp32", "batch_size=2",
            "max_cache_len=256", f"server.port={port}"]


def test_serving_cli_runs_with_the_card_libraries_blocked(tmp_path):
    """``python -m ssi_tpu_torch.cli.serve model=<tiny step dir> +device=cpu
    server.port=<free>`` starts with every library of ``_NOT_ON_THE_CARD``
    blocked from import, answers ``/health`` and a greedy completion equal to
    the naive oracle, exits 0 on SIGINT after writing its launch-count line,
    and loaded neither jax nor ``ssi_tpu``."""
    import json
    import signal
    import time
    import urllib.request

    import jax
    import jax.numpy as jnp
    import numpy as np

    from ssi_tpu.models.llama3 import init_params
    from ssi_tpu_torch.tokenizer import setup_llama3_tokenizer
    from tests import helpers

    model_dir = helpers.make_tiny_hf_checkpoint(tmp_path / "step_0")
    block = tmp_path / "block"
    block.mkdir()
    (block / "sitecustomize.py").write_text(_BLOCKER.format(names=repr(set(_NOT_ON_THE_CARD))))
    env = {k: v for k, v in os.environ.items() if k != "SSI_TPU_COMPILE_CACHE"}
    counts = tmp_path / "launches.jsonl"
    env.update(PYTHONPATH=f"{block}{os.pathsep}{REPO}", OMP_NUM_THREADS="2", SSI_TPU_TORCH_LAUNCH_COUNTS=str(counts))
    port = _free_port()
    args = _serve_args(model_dir, port)
    code = _SERVE_RUN.replace("NAMES", repr(_NOT_ON_THE_CARD))
    proc = subprocess.Popen([sys.executable, "-c", code, *args, "+device=cpu"], cwd=tmp_path, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    url = f"http://127.0.0.1:{port}"
    try:
        for _ in range(600):
            assert proc.poll() is None, proc.communicate()[1][-3000:]
            try:
                with urllib.request.urlopen(url + "/health", timeout=5) as r:
                    assert json.loads(r.read()) == {"status": "ok"}
                break
            except OSError:
                time.sleep(0.1)
        prompt = [5, 17, 42, 99, 3, 250, 7]
        req = urllib.request.Request(url + "/v1/completions", headers={"Content-Type": "application/json"},
                                     data=json.dumps({"prompt": prompt, "max_tokens": 6}).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            body = json.loads(r.read())
    finally:
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err[-3000:]
    assert "SERVE_OK" in out and f"serving on http://127.0.0.1:{port}" in out
    cfg = helpers.tiny_config()
    want = helpers.naive_greedy(init_params(cfg, jax.random.key(0), dtype=jnp.float32), cfg, prompt, 6)
    got = body["choices"][0]["token_ids"]
    stops = set(setup_llama3_tokenizer(model_dir / "original" / "tokenizer.model", verbose=False)[0].stop_tokens)
    k = next((i for i, t in enumerate(want) if t in stops), None)
    assert got == (want if k is None else want[: k + 1]), (got, want)
    assert np.asarray(got).max() < cfg.vocab_size
    assert json.loads(counts.read_text().splitlines()[-1])["entry_point"] == "serve"


def test_n_gt_1_generation_and_serving_load_no_card_library(tmp_path):
    """``sampling_params.n=3`` through the generation CLI, then an ``n: 2``
    request to the serving CLI, each a process with every library of
    ``_NOT_ON_THE_CARD`` blocked from import: three outputs per record, two
    equal greedy choices, and neither process loaded jax, ``ssi_tpu`` or an
    optional package (the gangs, the page copy and the depth-2 pipeline
    included)."""
    import json
    import signal
    import time
    import urllib.request

    from tests import helpers

    model_dir = helpers.make_tiny_hf_checkpoint(tmp_path / "step_0")
    split = tmp_path / "test.jsonl"
    split.write_text("".join(json.dumps(r) + "\n" for r in helpers.synthetic_sft_rows(2)))
    block = tmp_path / "block"
    block.mkdir()
    (block / "sitecustomize.py").write_text(_BLOCKER.format(names=repr(set(_NOT_ON_THE_CARD))))
    env = {k: v for k, v in os.environ.items() if k != "SSI_TPU_COMPILE_CACHE"}
    env.update(PYTHONPATH=f"{block}{os.pathsep}{REPO}", OMP_NUM_THREADS="2")
    code = _CLI_RUN.replace("NAMES", repr(_NOT_ON_THE_CARD))
    args = _cli_overrides(model_dir, split, tmp_path / "gens")
    proc = subprocess.run([sys.executable, "-c", code, *args, "batch_size=4", "sampling_params.n=3", "+device=cpu"], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "CLI_OK" in proc.stdout
    records = [json.loads(line) for line in
               (tmp_path / "gens" / "json" / "test" / "generations.jsonl").read_text().splitlines()]
    assert len(records) == 2 and all(len(r["outputs"]) == 3 for r in records)

    port = _free_port()
    proc = subprocess.Popen([sys.executable, "-c", _SERVE_RUN.replace("NAMES", repr(_NOT_ON_THE_CARD)),
                             *_serve_args(model_dir, port), "+device=cpu"], cwd=tmp_path, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    url = f"http://127.0.0.1:{port}"
    try:
        for _ in range(600):
            assert proc.poll() is None, proc.communicate()[1][-3000:]
            try:
                with urllib.request.urlopen(url + "/health", timeout=5):
                    break
            except OSError:
                time.sleep(0.1)
        req = urllib.request.Request(url + "/v1/completions", headers={"Content-Type": "application/json"},
                                     data=json.dumps({"prompt": [5, 17, 42, 99, 3], "max_tokens": 4, "n": 2}).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            body = json.loads(r.read())
    finally:
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err[-3000:]
    assert "SERVE_OK" in out
    choices = body["choices"]
    assert len(choices) == 2 and choices[0]["token_ids"] == choices[1]["token_ids"]


_BLOCKED_RUNS = {
    "packed_sft": """
import sys
from ssi_tpu_torch.cli import train_sft
model, out, sft = sys.argv[1:4]
common = ["data=sft/mls-hubert_large_ll60k-layer_22", "model_config=tiny_test", "speech.n_dsus=16",
          f"checkpointer.checkpoint_dir={model}", f"tokenizer.path={model}/original/tokenizer.model",
          "tokenizer.max_seq_len=384", "max_steps=2", "save_steps=2", "eval_steps=2", "wandb.enabled=false",
          "hydra/job_logging=none", "gradient_accumulation_steps=1", "+device=cpu"]
for split in ("train", "dev"):
    common += [f"data.{split}.dataset.source=json", f"data.{split}.dataset.split=train",
               f"+data.{split}.dataset.data_files={sft}", f"data.{split}.dataloader.batch_size=2",
               f"data.{split}.packed=true"]
for window in (None, 4):
    extra = [] if window is None else [f"data.train.pack_window={window}", f"data.dev.pack_window={window}"]
    trainer = train_sft.main([*common, f"checkpointer.output_dir={out}/w{window}", *extra])
    assert trainer.global_step == 2 and type(trainer.data_train.dataset).__name__ == (
        "PackedDataset" if window is None else "WindowedPackedDataset"), trainer
""",
    "dense_generate": """
import runpy, sys
sys.argv = ["ssi_tpu_torch.cli.generate", *sys.argv[4:], "engine=dense", "+device=cpu"]
runpy.run_module("ssi_tpu_torch.cli.generate", run_name="__main__")
""",
    "generate_sample": """
import runpy, sys
model = sys.argv[1]
sys.argv = ["ssi_tpu_torch.cli.generate_sample", "--model", model, "--n_dsus", "16", "--model_config", "tiny_test",
            "--dtype", "fp32", "--max_tokens", "4", "--template", "repeat_this_modality_switch",
            "--speech_tokens", "3", "3", "7", "--deduplicate", "--device", "cpu"]
runpy.run_module("ssi_tpu_torch.cli.generate_sample", run_name="__main__")
""",
}


@pytest.mark.parametrize("run", sorted(_BLOCKED_RUNS))
def test_packed_training_dense_generation_and_generate_sample_load_no_card_library(tmp_path, run):
    """The packed SFT CLI (with and without ``pack_window``), the generation
    CLI with ``engine=dense`` and ``python -m ssi_tpu_torch.cli.generate_sample``
    on a shipped template, each a process with every library of
    ``_NOT_ON_THE_CARD`` blocked from import (jinja2 too: the shipped
    templates render without it): each runs to its end and loaded neither
    jax, ``ssi_tpu`` nor an optional package."""
    import json

    from tests import helpers

    model_dir = helpers.make_tiny_hf_checkpoint(tmp_path / "step_0")
    split = tmp_path / "rows.jsonl"
    split.write_text("".join(json.dumps(r) + "\n" for r in helpers.synthetic_sft_rows(8)))
    block = tmp_path / "block"
    block.mkdir()
    (block / "sitecustomize.py").write_text(_BLOCKER.format(names=repr(set(_NOT_ON_THE_CARD))))
    env = {k: v for k, v in os.environ.items() if k != "SSI_TPU_COMPILE_CACHE"}
    env.update(PYTHONPATH=f"{block}{os.pathsep}{REPO}", OMP_NUM_THREADS="2")
    code = _BLOCKED_RUNS[run] + f"""
loaded = sorted(m for m in sys.modules if m.split(".")[0] in {_NOT_ON_THE_CARD!r})
assert loaded == [], loaded
print("BLOCKED_RUN_OK")
"""
    args = [str(model_dir), str(tmp_path / "out"), str(split), *_cli_overrides(model_dir, split, tmp_path / "gens")]
    proc = subprocess.run([sys.executable, "-c", code, *args], cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert "BLOCKED_RUN_OK" in proc.stdout
    if run == "dense_generate":
        lines = (tmp_path / "gens" / "json" / "test" / "generations.jsonl").read_text().splitlines()
        assert len(lines) == 8 and all(json.loads(line)["finished"] for line in lines)


def _two_rank_sft_under_torchrun(tmp_path, *extra: str) -> Path:
    """The SFT CLI under ``torchrun --standalone --nproc_per_node 2`` with
    ``extra`` overrides (gloo, ``+device=cpu``), every library of
    ``_NOT_ON_THE_CARD`` blocked from import in the launcher and both ranks;
    2 steps. Returns the output directory."""
    import json

    from tests import helpers

    model_dir = helpers.make_tiny_hf_checkpoint(tmp_path / "step_0")
    split = tmp_path / "rows.jsonl"
    split.write_text("".join(json.dumps(r) + "\n" for r in helpers.synthetic_sft_rows(16)))
    block = tmp_path / "block"
    block.mkdir()
    (block / "sitecustomize.py").write_text(_BLOCKER.format(names=repr(set(_NOT_ON_THE_CARD))))
    env = {k: v for k, v in os.environ.items() if k != "SSI_TPU_COMPILE_CACHE"}
    env.update(PYTHONPATH=f"{block}{os.pathsep}{REPO}", OMP_NUM_THREADS="2")
    out = tmp_path / "out"
    args = ["data=sft/mls-hubert_large_ll60k-layer_22", "model_config=tiny_test", "speech.n_dsus=16",
            f"checkpointer.checkpoint_dir={model_dir}", f"tokenizer.path={model_dir}/original/tokenizer.model",
            "tokenizer.max_seq_len=384", "max_steps=2", "save_steps=2", "eval_steps=2", "wandb.enabled=false",
            "hydra/job_logging=none", "gradient_accumulation_steps=1", f"checkpointer.output_dir={out}",
            "parallel.distributed=true", *extra, "+device=cpu"]
    for name in ("train", "dev"):
        args += [f"data.{name}.dataset.source=json", f"data.{name}.dataset.split=train",
                 f"+data.{name}.dataset.data_files={split}", f"data.{name}.dataloader.batch_size=2"]
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
                           "-m", "ssi_tpu_torch.cli.train_sft", *args], cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    metrics = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [m["step"] for m in metrics if "loss" in m] == [1, 2]
    assert (out / "step_2" / "model.safetensors.index.json").is_file()
    return out


def test_two_rank_sft_cli_under_torchrun_loads_no_card_library(tmp_path):
    """``python -m torch.distributed.run --standalone --nproc_per_node 2 -m
    ssi_tpu_torch.cli.train_sft ... parallel.distributed=true +device=cpu``
    (gloo, ZeRO-1), with every library of ``_NOT_ON_THE_CARD`` blocked from
    import in the launcher and both ranks: the CLI runs unchanged under
    torchrun, the ranks read the launcher's variables, and rank 0 alone
    writes the metrics, ``step_2/`` and a state of world size 2."""
    from ssi_tpu_torch.checkpoint import msgpack_io

    out = _two_rank_sft_under_torchrun(tmp_path, "parallel.zero1=true")
    state = msgpack_io.load(out / "training_state.msgpack")
    assert state["training_hparams"]["world_size"] == 2 and state["consumed_samples"] == 2 * 2 * 2


def test_tensor_parallel_sft_cli_under_torchrun_loads_no_card_library(tmp_path):
    """The same at ``parallel.tp=2``: the two ranks are one dp column (one
    data replica, so a state of world size 1) whose tp ranks split the heads,
    the MLP and the vocabulary; rank 0 writes the whole ``step_2/``."""
    from ssi_tpu_torch.checkpoint import msgpack_io
    from ssi_tpu_torch.checkpoint.safetensors_io import load_file

    out = _two_rank_sft_under_torchrun(tmp_path, "parallel.tp=2")
    state = msgpack_io.load(out / "training_state.msgpack")
    assert state["training_hparams"]["world_size"] == 1 and state["consumed_samples"] == 2 * 2
    weights = {}
    for f in (out / "step_2").glob("*.safetensors"):
        weights.update(load_file(f))
    assert weights["model.embed_tokens.weight"].shape == (530, 64)


def test_tensor_parallel_generate_under_torchrun_loads_no_card_library(tmp_path):
    """``python -m torch.distributed.run --standalone --nproc_per_node 2``
    of the generation CLI with ``tensor_parallel=2 +device=cpu`` (two gloo
    ranks), every library of ``_NOT_ON_THE_CARD`` blocked in the launcher and
    both ranks: rank 0 writes the ``generations.jsonl`` of the one-process
    run, line for line, and neither rank loaded one of them."""
    import json

    from tests import helpers

    model_dir = helpers.make_tiny_hf_checkpoint(tmp_path / "step_0")
    split = tmp_path / "test.jsonl"
    split.write_text("".join(json.dumps(r) + "\n" for r in helpers.synthetic_sft_rows(3)))
    block = tmp_path / "block"
    block.mkdir()
    (block / "sitecustomize.py").write_text(_BLOCKER.format(names=repr(set(_NOT_ON_THE_CARD))))
    env = {k: v for k, v in os.environ.items() if k != "SSI_TPU_COMPILE_CACHE"}
    env.update(PYTHONPATH=f"{block}{os.pathsep}{REPO}", OMP_NUM_THREADS="1")
    script = tmp_path / "run_cli.py"
    script.write_text(_CLI_RUN.replace("NAMES", repr(_NOT_ON_THE_CARD)))
    runs = {"one": [sys.executable, str(script)],
            "tp2": [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2", str(script)]}
    lines = {}
    for name, cmd in runs.items():
        extra = ["tensor_parallel=2"] if name == "tp2" else []
        proc = subprocess.run([*cmd, *_cli_overrides(model_dir, split, tmp_path / name), *extra, "+device=cpu"],
                              cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
        assert proc.stdout.count("CLI_OK") == (2 if name == "tp2" else 1)
        lines[name] = (tmp_path / name / "json" / "test" / "generations.jsonl").read_text().splitlines()
    assert len(lines["one"]) == 3
    for a, b in zip(lines["tp2"], lines["one"]):
        ra, rb = json.loads(a), json.loads(b)
        for oa, ob in zip(ra["outputs"], rb["outputs"]):
            # two ranks' partial sums add in another order: log-probabilities to 1e-5
            assert oa.pop("cumulative_logprob") == pytest.approx(ob.pop("cumulative_logprob"), rel=1e-5, abs=1e-6)
            assert oa.pop("logprobs") == pytest.approx(ob.pop("logprobs"), rel=1e-5, abs=1e-6)
        assert ra == rb


def test_tensor_parallel_serving_under_torchrun_loads_no_card_library(tmp_path):
    """The serving CLI under ``torchrun --standalone --nproc_per_node 2``
    with ``tensor_parallel=2 +device=cpu``, every library of
    ``_NOT_ON_THE_CARD`` blocked: rank 0 binds the port and answers
    ``/health`` and a greedy completion equal to the one-process server's
    (the naive oracle's tokens); a streamed request cut by its client mid-
    stream (a cancel on rank 0) leaves the ranks in step for the next
    completion; SIGINT to rank 0 stops it, it releases rank 1, and both
    ranks and torchrun exit 0 without loading a blocked library."""
    import json
    import re
    import signal
    import time
    import urllib.request

    import jax
    import jax.numpy as jnp

    from ssi_tpu.models.llama3 import init_params
    from ssi_tpu_torch.tokenizer import setup_llama3_tokenizer
    from tests import helpers

    model_dir = helpers.make_tiny_hf_checkpoint(tmp_path / "step_0")
    block = tmp_path / "block"
    block.mkdir()
    (block / "sitecustomize.py").write_text(_BLOCKER.format(names=repr(set(_NOT_ON_THE_CARD))))
    env = {k: v for k, v in os.environ.items() if k != "SSI_TPU_COMPILE_CACHE"}
    env.update(PYTHONPATH=f"{block}{os.pathsep}{REPO}", OMP_NUM_THREADS="1")
    script = tmp_path / "run_serve.py"
    script.write_text(_SERVE_RUN.replace("NAMES", repr(_NOT_ON_THE_CARD)))
    port = _free_port()
    log = tmp_path / "serve.log"
    with open(log, "w") as sink:
        proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
                                 "2", str(script), *_serve_args(model_dir, port), "tensor_parallel=2", "+device=cpu"],
                                cwd=tmp_path, env=env, stdout=sink, stderr=subprocess.STDOUT, text=True)
    url = f"http://127.0.0.1:{port}"

    def complete(prompt, max_tokens, **extra):
        req = urllib.request.Request(url + "/v1/completions", headers={"Content-Type": "application/json"},
                                     data=json.dumps({"prompt": prompt, "max_tokens": max_tokens, **extra}).encode())
        return urllib.request.urlopen(req, timeout=120)

    try:
        for _ in range(600):
            assert proc.poll() is None, log.read_text()[-3000:]
            try:
                with urllib.request.urlopen(url + "/health", timeout=5) as r:
                    assert json.loads(r.read()) == {"status": "ok"}
                break
            except OSError:
                time.sleep(0.1)
        prompt = [5, 17, 42, 99, 3, 250, 7]
        with complete(prompt, 6) as r:
            body = json.loads(r.read())
        with complete([9, 8, 7, 6, 5], 40, stream=True) as r:  # the client reads one chunk and goes away
            r.readline()
        with complete(prompt, 6) as r:
            again = json.loads(r.read())
        pids = dict(re.findall(r"tensor-parallel rank (\d) of 2 \(pid (\d+)\)", log.read_text()))
        os.kill(int(pids["0"]), signal.SIGINT)
        proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = log.read_text()
    assert proc.returncode == 0, out[-3000:]
    assert out.count("SERVE_OK") == 2 and set(pids) == {"0", "1"} and f"serving on http://127.0.0.1:{port}" in out
    cfg = helpers.tiny_config()
    want = helpers.naive_greedy(init_params(cfg, jax.random.key(0), dtype=jnp.float32), cfg, prompt, 6)
    stops = set(setup_llama3_tokenizer(model_dir / "original" / "tokenizer.model", verbose=False)[0].stop_tokens)
    k = next((i for i, t in enumerate(want) if t in stops), None)
    assert body["choices"][0]["token_ids"] == again["choices"][0]["token_ids"] == (want if k is None else want[: k + 1])


_COMPRESSED_RUNS = {
    "train_dsu_bpe": """
import runpy, sys
sys.argv = ["ssi_tpu_torch.cli.train_dsu_bpe", sys.argv[2] + "/bpe", "--dataset", "json", "--data-files",
            sys.argv[3], "--n-merges", "32", "--deduplicate"]
runpy.run_module("ssi_tpu_torch.cli.train_dsu_bpe", run_name="__main__")
""",
    "cl100k_generate": """
import runpy, sys
sys.argv = ["ssi_tpu_torch.cli.generate", *sys.argv[4:], "tokenizer.pattern=cl100k", "+device=cpu"]
runpy.run_module("ssi_tpu_torch.cli.generate", run_name="__main__")
""",
}


@pytest.mark.parametrize("run", sorted(_COMPRESSED_RUNS))
def test_compressed_dsu_clis_load_no_card_library(tmp_path, run):
    """``python -m ssi_tpu_torch.cli.train_dsu_bpe`` over a JSON-lines split,
    and the generation CLI with ``tokenizer.pattern=cl100k`` on a tiny
    compressed checkpoint (its tokenizer the base plus trained DSU merges),
    each a process with every library of ``_NOT_ON_THE_CARD`` blocked from
    import (tiktoken, regex and datasets among them): each runs to its end and
    loaded none of them."""
    import json

    from ssi_tpu_torch.speech import dsu2pua
    from ssi_tpu_torch.tokenizer.bpe_train import merge_into_tokenizer, train_bpe
    from tests import helpers

    rows = helpers.synthetic_sft_rows(8)
    split = tmp_path / "rows.jsonl"
    split.write_text("".join(json.dumps(r) + "\n" for r in rows))
    ranks = train_bpe(["".join(dsu2pua(t) for t in r["speech_tokens"]) for r in rows], 24)
    base = helpers.write_tiny_tokenizer(tmp_path / "base.model")
    n_new = merge_into_tokenizer(base, ranks, tmp_path / "compressed.model", use_modality_tokens=True)
    model_dir = helpers.make_tiny_hf_checkpoint(tmp_path / "step_0", n_dsus=n_new)
    (model_dir / "original" / "tokenizer.model").write_bytes((tmp_path / "compressed.model").read_bytes())
    block = tmp_path / "block"
    block.mkdir()
    (block / "sitecustomize.py").write_text(_BLOCKER.format(names=repr(set(_NOT_ON_THE_CARD))))
    env = {k: v for k, v in os.environ.items() if k != "SSI_TPU_COMPILE_CACHE"}
    env.update(PYTHONPATH=f"{block}{os.pathsep}{REPO}", OMP_NUM_THREADS="2")
    code = _COMPRESSED_RUNS[run] + f"""
loaded = sorted(m for m in sys.modules if m.split(".")[0] in {_NOT_ON_THE_CARD!r})
assert loaded == [], loaded
print("BLOCKED_RUN_OK")
"""
    gen = [a.replace("speech.n_dsus=16", f"speech.n_dsus={n_new}")
           for a in _cli_overrides(model_dir, split, tmp_path / "gens")]
    proc = subprocess.run([sys.executable, "-c", code, str(model_dir), str(tmp_path / "out"), str(split), *gen],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert "BLOCKED_RUN_OK" in proc.stdout
    if run == "train_dsu_bpe":
        stats = json.loads((tmp_path / "out" / "bpe" / "stats.json").read_text())
        assert stats["n_rows"] == 8 and stats["n_merges_learned"] == 32
    else:
        lines = (tmp_path / "gens" / "json" / "test" / "generations.jsonl").read_text().splitlines()
        assert len(lines) == 8 and all(json.loads(line)["finished"] for line in lines)


_LOCAL_RUNS = {
    "sft_parquet_directory": """
import sys
from ssi_tpu_torch.cli import train_sft
model, out, directory = sys.argv[1:4]
trainer = train_sft.main([
    "data=sft/mls-hubert_large_ll60k-layer_22", "model_config=tiny_test", "speech.n_dsus=16",
    f"checkpointer.checkpoint_dir={model}", f"tokenizer.path={model}/original/tokenizer.model",
    "tokenizer.max_seq_len=384", "max_steps=2", "save_steps=2", "eval_steps=2", "wandb.enabled=false",
    "gradient_accumulation_steps=1", "+device=cpu", f"checkpointer.output_dir={out}",
    f"data.train.dataset.source={directory}", f"data.dev.dataset.source={directory}",
    "data.dev.dataset.split=validation", "data.train.dataloader.batch_size=2", "data.dev.dataloader.batch_size=2"])
assert trainer.global_step == 2 and len(trainer.data_train.dataset) == 6, trainer
""",
    "cpt_raw_regex_pattern": """
import sys
from ssi_tpu_torch.cli import train_cpt
from ssi_tpu_torch.tokenizer import CL100K_PATTERN_PUA
model, out, _, rows = sys.argv[1:5]
common = ["data=cpt/mls-hubert_large_ll60k-layer_22", "model_config=tiny_test", "speech.n_dsus=16",
          f"checkpointer.checkpoint_dir={model}", f"tokenizer.path={model}/original/tokenizer.model",
          "tokenizer.max_seq_len=256", "max_steps=2", "save_steps=2", "eval_steps=2", "wandb.enabled=false",
          "gradient_accumulation_steps=1", "+device=cpu", f"tokenizer.pattern=(?:{CL100K_PATTERN_PUA})"]
for split in ("train", "dev"):
    common += [f"data.{split}.dataset.source=json", f"+data.{split}.dataset.data_files={rows}",
               f"data.{split}.dataset.split=train", f"data.{split}.dataloader.batch_size=2"]
trainer = train_cpt.main([*common, f"checkpointer.output_dir={out}"])
assert trainer.global_step == 2 and trainer.tokenizer._split is not None, trainer
""",
    "plot_wandb_losses": """
import json, runpy, sys
from pathlib import Path
run = Path(sys.argv[2]) / "myrun-id_abc"
(run / "generations" / "step_2" / "mls-x" / "dev").mkdir(parents=True)
(run / "generations" / "step_2" / "mls-x" / "dev" / "wer.json").write_text(json.dumps({"wer": 0.25}))
(run / "metrics.jsonl").write_text("".join(json.dumps({"step": s, "loss": 3.0 / s}) + "\\n" for s in (1, 2, 3)))
sys.argv = ["ssi_tpu_torch.cli.plot_wandb_losses", str(run / "generations"), str(run / "plots")]
runpy.run_module("ssi_tpu_torch.cli.plot_wandb_losses", run_name="__main__")
assert (run / "plots" / "losses_log.png").stat().st_size > 1000
""",
    "plt_embed_tsne": """
import runpy, sys
from pathlib import Path
model, out = sys.argv[1:3]
sys.argv = ["ssi_tpu_torch.cli.plt_embed_tsne", f"output_dir={out}/tsne", f"checkpointer.checkpoint_dir={model}",
            "+model_config=tiny_test", "speech.n_dsus=16", "tsne.perplexities=[5]", "tsne.max_points=200"]
runpy.run_module("ssi_tpu_torch.cli.plt_embed_tsne", run_name="__main__")
assert (Path(out) / "tsne" / "embeddings_by_token_type.png").stat().st_size > 1000
""",
}


@pytest.mark.parametrize("run", sorted(_LOCAL_RUNS))
def test_local_sources_regex_patterns_and_plots_load_no_card_library(tmp_path, run):
    """The SFT CLI reading both splits from a parquet dataset directory (the
    HF repo layout, no ``data_files``), the CPT CLI with ``tokenizer.pattern``
    a raw regex, and the two plotting CLIs, each a process with every library
    of ``_NOT_ON_THE_CARD`` blocked from import (``regex`` allowed where the
    pattern needs it): each runs to its end and loaded neither jax,
    ``ssi_tpu``, ``datasets`` nor tiktoken."""
    import json

    import pyarrow as pa
    import pyarrow.parquet as pq

    from tests import helpers

    model_dir = helpers.make_tiny_hf_checkpoint(tmp_path / "step_0")
    rows = helpers.synthetic_sft_rows(8)
    directory = tmp_path / "hf"
    (directory / "data").mkdir(parents=True)
    for name, part in (("train-00000-of-00002", rows[:3]), ("train-00001-of-00002", rows[3:6]),
                       ("validation-00000-of-00001", rows[6:])):
        pq.write_table(pa.Table.from_pylist(part), directory / "data" / f"{name}.parquet")
    cpt = tmp_path / "cpt.jsonl"
    cpt.write_text("".join(json.dumps(r) + "\n" for r in helpers.synthetic_cpt_rows(8)))
    blocked = set(_NOT_ON_THE_CARD) - ({"regex"} if run == "cpt_raw_regex_pattern" else set())
    block = tmp_path / "block"
    block.mkdir()
    (block / "sitecustomize.py").write_text(_BLOCKER.format(names=repr(blocked)))
    env = {k: v for k, v in os.environ.items() if k != "SSI_TPU_COMPILE_CACHE"}
    env.update(PYTHONPATH=f"{block}{os.pathsep}{REPO}", OMP_NUM_THREADS="2", MPLBACKEND="Agg")
    code = _LOCAL_RUNS[run] + f"""
loaded = sorted(m for m in sys.modules if m.split(".")[0] in {sorted(blocked)!r})
assert loaded == [], loaded
print("BLOCKED_RUN_OK")
"""
    proc = subprocess.run([sys.executable, "-c", code, str(model_dir), str(tmp_path / "out"), str(directory),
                           str(cpt)], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert "BLOCKED_RUN_OK" in proc.stdout


_OPTIONAL = ("pyarrow", "regex", "matplotlib", "seaborn", "sklearn")


def test_optional_libraries_are_imported_only_inside_the_functions_that_need_them():
    """``pyarrow``, ``regex``, matplotlib, seaborn and sklearn: no port source
    imports one with an import statement, and each is imported through
    ``utils.import_optional`` (a refusal naming it when it is missing)
    inside a function, never at a module's top level."""
    names = "|".join(_OPTIONAL)
    statement = re.compile(rf"^\s*(import|from)\s+({names})(\.|\s|$)", re.MULTILINE)
    call = re.compile(rf"^(\s*).*import_optional\(\s*\"({names})[.\"]", re.MULTILINE)
    sources = [p for p in (REPO / "ssi_tpu_torch").rglob("*.py") if "_build" not in p.parts] + [REPO / "chip_smoke.py"]
    offenders, found = [], set()
    for path in sources:
        text = path.read_text()
        offenders += [f"{path}: {m.group(0).strip()}" for m in statement.finditer(text)]
        for m in call.finditer(text):
            found.add(m.group(2))
            if not m.group(1):
                offenders.append(f"{path}: {m.group(0).strip()} at the top level")
    assert offenders == []
    assert found == set(_OPTIONAL)


def test_serving_cli_refuses_without_a_card(tmp_path):
    """Without ``+device=cpu`` and with no CUDA device, the serving CLI
    refuses before it loads the tokenizer or the checkpoint (no CPU fallback)."""
    import torch

    from tests import helpers

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; this checks the no-GPU refusal")
    model_dir = helpers.make_tiny_hf_checkpoint(tmp_path / "step_0")
    env = {k: v for k, v in os.environ.items() if k != "SSI_TPU_COMPILE_CACHE"}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-m", "ssi_tpu_torch.cli.serve", *_serve_args(model_dir, _free_port())],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "+device=cpu" in proc.stderr
    assert "Loaded Llama 3 tokenizer" not in proc.stdout and "Loading from checkpoint" not in proc.stdout
    assert "serving on" not in proc.stdout


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


def test_signatures_match_the_c_entry_points_argument_for_argument():
    """Each ``extern "C"`` entry point's parameters, in order, against the
    ctypes argtypes ``_build`` declares for it: a pointer for each pointer,
    ``c_int`` for ``int``, ``c_longlong`` for ``long long``, ``c_float`` for
    ``float``. A missing or misplaced argument (a head_dim added to one side
    only) would pass every later argument in the wrong register."""
    import ctypes

    kinds = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float}
    entry = re.compile(r'extern "C" int (\w+)\(([^)]*)\)')
    seen = set()
    for path in _build._sources():
        for name, params in entry.findall(path.read_text()):
            want = []
            for param in (p.strip() for p in params.split(",") if p.strip()):
                decl = param.rsplit(" ", 1)[0].replace("const ", "").strip()
                want.append(ctypes.c_void_p if "*" in param else kinds[decl])
            assert _build._SIGNATURES[name] == want, name
            seen.add(name)
    assert seen == set(_build._SIGNATURES)
