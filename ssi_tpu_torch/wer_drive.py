"""The port's WER drive: the full pipeline end to end through ``ssi_tpu_torch``
on the CUDA card — the twin of ``tools/wer_drive.py``.

    extend_llama3_2 -> train_sft -> generate (bf16 AND int8) -> wer_parity

Every stage runs as a subprocess of the port's CLI
(``python -m ssi_tpu_torch.cli.{extend_llama3_2,train_sft,generate,wer_parity}``)
with the JAX drive's config-surface overrides letter for letter; nothing here
has a private code path. The inputs are synthesized offline as the JAX drive
synthesizes them, with the same seed:

- the 128,000-entry base ``tokenizer.model`` (``build_base_tokenizer``) and
  the learnable DSU-ASR corpus (``build_corpus``: one position-free DSU per
  word, 10 words per utterance, 256k distinct training rows) are copies of
  the JAX drive's functions, held byte-equal to them by
  ``tests/test_torch_wer_drive.py``;
- the random-init base checkpoint (``build_base_checkpoint``: fp32
  safetensors, ``config.json``, ``generation_config.json``,
  ``original/params.json``) is written by the port (``init_params``,
  ``internal_to_hf``, its safetensors writer). Its random weights differ from
  the JAX drive's (another generator); the bar is the WER record, not the
  weights.

Usage (on the card's machine; the drive refuses to start without a card)::

    python -m ssi_tpu_torch.wer_drive                               # full drive, llama3_2_100m
    python -m ssi_tpu_torch.wer_drive --workdir /tmp/wd --smoke      # wiring check
    python -m ssi_tpu_torch.wer_drive ... --phases assets,extend,train   # partial
    python -m ssi_tpu_torch.wer_drive --smoke --device cpu --model-config tiny_test --n-dsus 400  # CPU

``--device cpu`` passes ``+device=cpu`` (``--device cpu`` to the extension
CLI) to every stage that runs the model; the tests use it. Artifacts land in
``--artifacts-dir`` (default ``artifacts/wer_drive_torch``): the two
``wer_parity_<bf16|int8>.json`` files and ``summary.json`` with the JAX
drive's keys, the card's name and power limit as ``hardware``, and the
port's own readings: seconds per stage, the SFT run's mean step time, label
tok/s and final losses, and the kernel launches of each stage's process
(each CLI appends its counts to the file ``$SSI_TPU_TORCH_LAUNCH_COUNTS``
names; see ``ssi_tpu_torch._build.write_launch_counts``).
"""

from __future__ import annotations

import argparse
import base64
import json
import logging
import os
from pathlib import Path
import shutil
import subprocess
import sys
import time

REPO = Path(__file__).resolve().parent.parent

LOGGER = logging.getLogger("wer_drive")

SEED = 20260819
BASE_VOCAB = 128_000
# Fixed utterance length: a constant speech->text alignment offset (see
# build_corpus for why this is load-bearing for from-scratch convergence)
N_WORDS = 10

# Task vocabulary: common English words (plus a few words whose British
# spellings exercise the vendored normalizer mapping on both sides).
WORDS = """
the of and to in is was he for it with as his on be at by had not are but from
or have an they which one you were all her she there would their we him been
has when who will no more if out so up said what its about than into them can
only other time new some could these two may first then do any like my now
over such our man me even most made after also did many off before must well
back through years much where your way down should because each just those
people too how little good world make very year still see own work men day get
here old life both between under never same another know while last might us
great old year came right used take three states himself few house use during
without again place american around however home small found mrs thought went
say part once general high upon school every don't does got united left number
course war until always away something fact though water less public put think
almost hand enough far took head yet government system better set told nothing
night end why called didn't eyes find going look asked later knew point next
city business case give group toward young let days true face others since
room mother social present friend power rather large family often kind four
among children however against state become interest big open possible
certain order early moved money ago second door white remember program
believe whole question began least word hours feel among side voice along
thing area want members mind country service best father door keep problem
music light education study turned want national care form given history
several change until help line fire name nature deal physical sense moment
free road colour theatre organise favourite centre behaviour honour analyse
programme labour neighbour travelled marvellous
""".split()


def _dedupe(seq):
    seen = set()
    out = []
    for w in seq:
        if w not in seen:
            seen.add(w)
            out.append(w)
    return out


WORDS = _dedupe(WORDS)

# the llama3_2_* base names the conf derives the extended model's name from
BASE_NAMES = {"llama3_2_100m": "Llama-3.2-100M", "llama3_2_1b": "Llama-3.2-1B", "llama3_2_3b": "Llama-3.2-3B"}
GEN_VARIANTS = [("bf16", "null"), ("int8", "int8")]


# ------------------------------------------------------------------------------
# Phase 1: assets
# ------------------------------------------------------------------------------


def build_base_tokenizer(path: Path, words: list[str]) -> None:
    """Write a valid 128,000-entry tiktoken BPE file.

    Layout (ranks ascending): 256 byte tokens; the 128 two-byte UTF-8
    intermediate merges for the PUA lead bytes 0xEE/0xEF (so the extension's
    appended 3-byte PUA tokens are reachable by byte-pair merging — tiktoken
    can only form a token if both halves of some split exist at lower ranks);
    prefix-chain merges for every task word (with and without leading space,
    sorted by length so each prefix outranks its extension); deterministic
    filler byte strings up to exactly 128,000 (valid, unreachable, harmless —
    real Llama vocab mass our task never touches).
    """
    tokens: list[bytes] = [bytes([i]) for i in range(256)]
    seen = set(tokens)

    def add(tok: bytes) -> None:
        if tok not in seen:
            seen.add(tok)
            tokens.append(tok)

    # UTF-8 intermediates for PUA chars U+E000..U+FFFF (lead bytes 0xEE, 0xEF)
    for lead in (0xEE, 0xEF):
        for b2 in range(0x80, 0xC0):
            add(bytes([lead, b2]))

    # Prefix-chain merges: every prefix (len >= 2) of each word variant, length-sorted
    merges: set[bytes] = set()
    for w in words:
        for variant in (w, " " + w):
            enc = variant.encode()
            for k in range(2, len(enc) + 1):
                merges.add(enc[:k])
    for tok in sorted(merges, key=lambda t: (len(t), t)):
        add(tok)

    # Filler: 2-byte high-lead pairs, then 3-byte 0xF8..0xFD-lead triples.
    for a in range(0x80, 0x100):
        for b in range(0x100):
            if len(tokens) >= BASE_VOCAB:
                break
            add(bytes([a, b]))
    for lead in range(0xF8, 0xFE):
        for a in range(0x100):
            for b in range(0x100):
                if len(tokens) >= BASE_VOCAB:
                    break
                add(bytes([lead, a, b]))

    if len(tokens) < BASE_VOCAB:
        raise RuntimeError(f"only {len(tokens)} tokens constructed")
    tokens = tokens[:BASE_VOCAB]
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for rank, tok in enumerate(tokens):
            f.write(base64.b64encode(tok).decode() + f" {rank}\n")
    LOGGER.info(f"base tokenizer.model: {len(tokens)} entries -> {path}")


def cut_to_base_vocab(path: Path, model_config: str) -> None:
    """Keep the first ``base_vocab_size_txt`` entries of the tokenizer file when
    the architecture's base vocabulary is narrower than ``BASE_VOCAB`` (the
    256 byte tokens for ``tiny_test``, the CPU tests' width); the Llama 3.2
    configs keep all 128,000."""
    from ssi_tpu_torch.models.configs import get_model_config

    n_base = get_model_config(model_config).base_vocab_size_txt
    if n_base < BASE_VOCAB:
        lines = path.read_text().splitlines(keepends=True)
        path.write_text("".join(lines[:n_base]))
        LOGGER.info(f"base tokenizer.model cut to the {model_config} base vocabulary: {n_base} entries")


def build_base_checkpoint(model_dir: Path, model_config: str, device: str) -> None:
    """Random-init base checkpoint in HF format, fp32 like the reference's base
    load (ref: scripts/extend_llama3_2.py:166), initialized on ``device`` from
    ``SEED`` by the port's ``init_params`` and written by its safetensors
    writer; the JSON files are the JAX drive's."""
    import torch

    from ssi_tpu_torch.checkpoint.convert import internal_to_hf
    from ssi_tpu_torch.checkpoint.safetensors_io import save_file
    from ssi_tpu_torch.models.configs import get_model_config
    from ssi_tpu_torch.models.llama3 import init_params

    cfg = get_model_config(model_config).copy()  # n_dsus=0: base (unextended) model
    (model_dir / "original").mkdir(parents=True, exist_ok=True)
    params = init_params(cfg, seed=SEED, dtype=torch.float32, device=device)
    save_file(internal_to_hf(params, cfg), model_dir / "model.safetensors")
    config = {
        "architectures": ["LlamaForCausalLM"],
        "model_type": "llama",
        "hidden_size": cfg.embed_dim,
        "intermediate_size": cfg.intermediate_dim,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "vocab_size": cfg.vocab_size,
        "bos_token_id": 128_000,
        "eos_token_id": 128_001,
        "tie_word_embeddings": True,
        "rope_theta": float(cfg.rope_base),
        "max_position_embeddings": cfg.max_seq_len,
    }
    (model_dir / "config.json").write_text(json.dumps(config, indent=2))
    (model_dir / "generation_config.json").write_text(
        json.dumps({"bos_token_id": 128_000, "eos_token_id": 128_001}, indent=2)
    )
    (model_dir / "original" / "params.json").write_text(json.dumps({"vocab_size": cfg.vocab_size}, indent=2))
    LOGGER.info(f"base {model_config} checkpoint (random init, fp32) -> {model_dir}")


def build_corpus(data_dir: Path, n_dsus: int, n_train: int, n_dev: int, n_test: int) -> dict:
    """Deterministic learnable DSU-ASR corpus: ONE position-free DSU per word
    (a copy of the JAX drive's ``build_corpus``; its docstring says why each
    choice is load-bearing for convergence from random init).

    - ``codes[w]``: one code per word, a bijective 313-entry codebook;
    - words within an utterance are sampled WITHOUT replacement (Zipf-0.6
      weights skew frequencies ACROSS utterances), so no code repeats inside
      an utterance and ``deduplicate: true`` stays lossless;
    - every utterance is exactly ``N_WORDS`` words, so the speech token for
      word i sits at a CONSTANT offset from the answer token for word i.
    """
    import numpy as np

    rng = np.random.default_rng(SEED)
    if n_dsus < len(WORDS):
        raise ValueError(f"n_dsus={n_dsus} < {len(WORDS)} words")
    perm = rng.permutation(n_dsus)[: len(WORDS)]
    codes: dict[str, int] = {w: int(c) for w, c in zip(WORDS, perm)}

    ranks = np.arange(1, len(WORDS) + 1, dtype=np.float64)
    p = 1.0 / ranks**0.6
    p /= p.sum()

    def make_rows(n: int, tag: str) -> list[dict]:
        rows = []
        for i in range(n):
            ws = [WORDS[j] for j in rng.choice(len(WORDS), N_WORDS, replace=False, p=p)]
            speech = [codes[w] for w in ws]
            rows.append({"ID": f"{tag}_{i}", "speech_tokens": speech, "transcript": " ".join(ws)})
        return rows

    data_dir.mkdir(parents=True, exist_ok=True)
    splits = {"train": make_rows(n_train, "tr"), "dev": make_rows(n_dev, "dv"), "test": make_rows(n_test, "te")}
    for name, rows in splits.items():
        with open(data_dir / f"{name}.jsonl", "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    with open(data_dir / "refs_test.jsonl", "w") as f:
        for r in splits["test"]:
            f.write(json.dumps({"transcript": r["transcript"]}) + "\n")
    (data_dir / "codebook.json").write_text(json.dumps(codes, indent=0))
    LOGGER.info(
        f"corpus: {n_train}/{n_dev}/{n_test} rows, {len(WORDS)} words, "
        f"{N_WORDS} words/utterance, bijective 1-code-per-word -> {data_dir}"
    )
    return codes


# ------------------------------------------------------------------------------
# Phase runners (the port's CLIs, config-surface overrides only)
# ------------------------------------------------------------------------------


def run(cmd: list, env: dict, log_to: Path) -> float:
    """Run one stage as a subprocess, its output appended to ``log_to``; raise
    with the log's tail if it fails. Returns its wall seconds."""
    LOGGER.info("RUN " + " ".join(map(str, cmd)))
    t0 = time.time()
    with open(log_to, "a") as f:
        proc = subprocess.run(list(map(str, cmd)), env=env, stdout=f, stderr=subprocess.STDOUT, cwd=REPO)
    if proc.returncode != 0:
        tail = log_to.read_text().splitlines()[-40:]
        raise RuntimeError(f"command failed ({proc.returncode}):\n" + "\n".join(tail))
    wall = time.time() - t0
    LOGGER.info(f"done in {wall:.1f}s")
    return wall


def assert_no_truncation(ext_dir: Path, data_dir: Path, max_seq_len: int,
                         model_overrides: list[str], data_overrides: list[str]) -> None:
    """Fail fast if any tokenized train row would be truncated at max_seq_len.

    Truncation silently amputates the transcript (the answer sits at the end of
    the sequence), leaving nothing supervised but headers and unpredictable DSU
    codes — the drive then trains to the DSU-marginal loss floor and WER never
    moves. Dataset settings (system prompt, train_on_input, dedup, column_map)
    are read through the port's composed config, so this guard cannot drift
    from what ``python -m ssi_tpu_torch.cli.train_sft`` will do.
    """
    from ssi_tpu_torch.config import compose
    from ssi_tpu_torch.data.sft import SFTDataset
    from ssi_tpu_torch.tokenizer import setup_llama3_tokenizer

    cfg = compose(str(REPO / "conf"), "sft",
                  ["data=sft/mls-hubert_large_ll60k-layer_22", *model_overrides, *data_overrides,
                   f"tokenizer.max_seq_len={max_seq_len}"])
    dcfg = cfg.data.train.dataset
    tok, _ = setup_llama3_tokenizer(ext_dir / "original" / "tokenizer.model",
                                    max_seq_len=max_seq_len, verbose=False)
    ds = SFTDataset(
        model_tokenizer=tok,
        source="json", data_files=str(data_dir / "train.jsonl"), split="train",
        deduplicate=bool(dcfg.deduplicate),
        use_modality_tokens=bool(dcfg.use_modality_tokens),
        train_on_input=bool(dcfg.train_on_input),
        column_map=dict(dcfg.column_map) if dcfg.column_map else None,
        new_system_prompt=dcfg.new_system_prompt,
        n_samples=300,
    )
    n = min(300, len(ds))
    worst = max(len(ds[i]["tokens"]) for i in range(n))
    if worst >= max_seq_len:
        raise RuntimeError(
            f"tokenized rows hit max_seq_len={max_seq_len} (longest of {n} sampled = {worst}): "
            "the transcript would be truncated away — raise --max-seq-len"
        )
    LOGGER.info(f"truncation guard: longest of {n} sampled rows = {worst} < max_seq_len={max_seq_len}")


def extended_dir(workdir: Path, args: argparse.Namespace) -> Path:
    """Where the extension stage writes the extended model (the conf's
    ``extended_models_dir/extended_model_name`` under ``SSI_TPU_HOME=workdir``)."""
    base_name = BASE_NAMES.get(args.model_config, args.model_config)
    return workdir / "models" / "extended" / f"{base_name}-{args.n_dsus}-dsus"


def data_split_overrides(data_dir: Path) -> list[str]:
    """The train and dev splits as JSON-lines files (``source=json``)."""
    out = []
    for split, fname in (("train", "train.jsonl"), ("dev", "dev.jsonl")):
        out += [
            f"data.{split}.dataset.source=json",
            f"+data.{split}.dataset.data_files={data_dir / fname}",
            f"data.{split}.dataset.split=train",
        ]
    return out


def sft_overrides(args: argparse.Namespace, data_dir: Path) -> list[str]:
    """The SFT stage's arguments (the JAX drive's, letter for letter)."""
    return ["data=sft/mls-hubert_large_ll60k-layer_22",
            f"model_config={args.model_config}",
            f"base_model_name={BASE_NAMES.get(args.model_config, args.model_config)}",
            *data_split_overrides(data_dir),
            f"data.train.dataloader.batch_size={args.batch_size}",
            f"data.dev.dataloader.batch_size={args.batch_size}",
            f"gradient_accumulation_steps={args.grad_accum}",
            f"tokenizer.max_seq_len={args.max_seq_len}",
            f"optimizer.lr={args.lr}",
            f"lr_scheduler.num_warmup_steps={args.warmup}",
            f"max_steps={args.max_steps}",
            f"eval_steps={args.eval_steps}",
            f"save_steps={args.max_steps}",
            "log_interval=20",
            "clip_grad_norm=1.0",
            "wandb.enabled=false",
            "loss_chunk_size=3072"]


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workdir", type=Path, default=REPO / ".wer_drive_torch")
    ap.add_argument("--artifacts-dir", type=Path, default=REPO / "artifacts" / "wer_drive_torch")
    ap.add_argument("--phases", default="assets,extend,train,generate,score,summary",
                    help="comma-separated subset of assets,extend,train,generate,score,summary")
    ap.add_argument("--n-dsus", type=int, default=5000)
    ap.add_argument(
        "--model-config",
        default="llama3_2_100m",
        help="Architecture registry key (llama3_2_100m converges on this budget; "
        "llama3_2_1b runs the full-scale architecture but cannot from random init)",
    )
    # One visit per row: 256k rows / (batch 32 x accum 2) = 4000 steps = ONE
    # epoch; with repeated rows the model memorizes utterances instead of
    # learning the codebook (tools/wer_drive.py)
    ap.add_argument("--n-train", type=int, default=256_000)
    ap.add_argument("--n-dev", type=int, default=192)
    ap.add_argument("--n-test", type=int, default=256)
    ap.add_argument("--max-steps", type=int, default=4000)
    ap.add_argument("--eval-steps", type=int, default=250)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--grad-accum", type=int, default=2)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--warmup", type=int, default=200)
    # the row budget must hold the ~67-token conf system prompt, headers, 10
    # speech tokens and a 10-word transcript (~109 tokens, ~129 worst case)
    ap.add_argument("--max-seq-len", type=int, default=160)
    ap.add_argument("--decode-slots", type=int, default=48)
    ap.add_argument("--smoke", action="store_true", help="tiny wiring check (few steps, few rows)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (the card, required unless cpu is asked for) or cpu (tests)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.n_train, args.n_dev, args.n_test = 256, 32, 16
        args.max_steps, args.eval_steps = 8, 4
        args.warmup = 2
    return args


def main(argv: list[str] | None = None) -> dict | None:
    args = parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("the WER drive runs on the CUDA card and none is visible; the port does not fall "
                               "back to the CPU: pass --device cpu to run on the CPU")

    t_start = time.time()
    phases = set(args.phases.split(","))
    W = args.workdir
    W.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ)
    env["SSI_TPU_HOME"] = str(W)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    py = sys.executable
    cpu = ["+device=cpu"] if args.device == "cpu" else []

    base_name = BASE_NAMES.get(args.model_config, args.model_config)
    base_dir = W / "models" / "base" / base_name
    ext_dir = extended_dir(W, args)
    data_dir = W / "data"
    log = W / "drive.log"
    launches_dir = W / "launches"
    launches_dir.mkdir(exist_ok=True)
    # seconds per stage, kept across partial runs for the summary
    seconds_file = W / "stage_seconds.json"
    seconds = json.loads(seconds_file.read_text()) if seconds_file.exists() else {}

    def timed(stage: str, cmd: list) -> None:
        stage_env = dict(env)
        counts = launches_dir / f"{stage}.jsonl"
        counts.unlink(missing_ok=True)
        stage_env["SSI_TPU_TORCH_LAUNCH_COUNTS"] = str(counts)
        seconds[stage] = run(cmd, stage_env, log)
        seconds_file.write_text(json.dumps(seconds, indent=2))

    # identity overrides shared by train + generate (conf/common.yaml derives
    # extended_model_name / tokenizer path from base_model_name)
    model_overrides = [f"model_config={args.model_config}", f"base_model_name={base_name}"]

    if "assets" in phases:
        t0 = time.time()
        build_base_tokenizer(base_dir / "original" / "tokenizer.model", WORDS)
        cut_to_base_vocab(base_dir / "original" / "tokenizer.model", args.model_config)
        build_base_checkpoint(base_dir, args.model_config, args.device)
        build_corpus(data_dir, args.n_dsus, args.n_train, args.n_dev, args.n_test)
        seconds["assets"] = time.time() - t0
        seconds_file.write_text(json.dumps(seconds, indent=2))

    if "extend" in phases:
        if ext_dir.exists():
            shutil.rmtree(ext_dir)
        # sigma 1.0: the base is RANDOM-INIT (mean ~0), so the reference's 1e-5
        # covariance scale would collapse every DSU row onto one ~zero vector
        timed("extend", [py, "-m", "ssi_tpu_torch.cli.extend_llama3_2",
                         "--n_new_dsus", args.n_dsus, "--model-config", args.model_config,
                         "--sigma-scaling", "1.0",
                         "--input_dir", base_dir, "--output_dir", ext_dir,
                         *(["--device", "cpu"] if cpu else [])])

    data_overrides = data_split_overrides(data_dir)

    if "train" in phases:
        assert_no_truncation(ext_dir, data_dir, args.max_seq_len, model_overrides, data_overrides)
        timed("train", [py, "-m", "ssi_tpu_torch.cli.train_sft", *sft_overrides(args, data_dir), *cpu])

    def latest_step_dir() -> Path:
        cands = sorted(W.glob("experiments/**/checkpoints/step_*"), key=lambda p: (p.stat().st_mtime, p.name))
        if not cands:
            raise FileNotFoundError(f"no step_N checkpoints under {W / 'experiments'}")
        return cands[-1]

    if "generate" in phases:
        step_dir = latest_step_dir()
        LOGGER.info(f"generating from {step_dir}")
        for tag, quant in GEN_VARIANTS:
            # observability=true runs an in-process warm-up pass before the
            # timed batch, so the records' tok/s leave first-use costs out
            out_root = W / f"gen_{tag}"
            if out_root.exists():
                shutil.rmtree(out_root)
            timed(f"generate_{tag}", [py, "-m", "ssi_tpu_torch.cli.generate",
                                      f"model={step_dir}",
                                      *model_overrides,
                                      "data=sft/mls-hubert_large_ll60k-layer_22",
                                      "data.test.dataset.source=json",
                                      f"+data.test.dataset.data_files={data_dir / 'test.jsonl'}",
                                      "data.test.dataset.split=train",
                                      "gen.split=test",
                                      f"gen.output_dir={out_root}",
                                      f"batch_size={args.decode_slots}",
                                      f"quantize_weights={quant}",
                                      "observability=true",
                                      *cpu])

    if "score" in phases:
        for tag, _ in GEN_VARIANTS:
            timed(f"score_{tag}", [py, "-m", "ssi_tpu_torch.cli.wer_parity",
                                   "--skip-generate", W / f"gen_{tag}" / "json" / "test",
                                   "--refs-jsonl", data_dir / "refs_test.jsonl"])

    if "summary" not in phases:
        return None
    art = args.artifacts_dir
    art.mkdir(parents=True, exist_ok=True)
    parity = {}
    for tag, _ in GEN_VARIANTS:
        src = W / f"gen_{tag}" / "json" / "test" / "wer_parity.json"
        parity[tag] = json.loads(src.read_text())
        shutil.copy(src, art / f"wer_parity_{tag}.json")
    delta = abs(parity["int8"]["wer"] - parity["bf16"]["wer"])
    speeds = {}
    for tag, _ in GEN_VARIANTS:
        gen = W / f"gen_{tag}" / "json" / "test" / "generations.jsonl"
        rows = [json.loads(line) for line in gen.read_text().splitlines()]
        m = rows[0].get("metrics") or {}
        speeds[tag] = m.get("batch_tokens_per_second")
    speeds["note"] = "steady-state (in-process warm-up batch first); includes prefill + weight staging"
    metrics = [json.loads(line) for line in (latest_step_dir().parent / "metrics.jsonl").read_text().splitlines()]
    steps = [m for m in metrics if "loss" in m]
    dev = [m["dev_loss"] for m in metrics if "dev_loss" in m]
    launches = {}
    for path in sorted(launches_dir.glob("*.jsonl")):
        for line in path.read_text().splitlines():
            launches[path.stem] = json.loads(line)["launch_counts"]
    summary = {
        "pipeline": "extend_llama3_2 -> train_sft -> generate(paged) -> wer_parity (ssi_tpu_torch CLIs)",
        "hardware": _device_desc(args.device),
        "model": f"{args.model_config} architecture, random init, extended +{args.n_dsus} DSUs (+2 modality)",
        "corpus": {
            "words": len(WORDS),
            "n_train": args.n_train,
            "n_test": args.n_test,
            "mapping": "one position-free DSU per word (bijective 313-entry codebook, "
            f"{N_WORDS} words/utterance, no within-utterance repeats, dedup-lossless)",
        },
        "train": {
            "max_steps": args.max_steps,
            "tokens_per_window": args.batch_size * args.grad_accum * args.max_seq_len,
            "lr": args.lr,
            # the port's readings of its SFT run (metrics.jsonl, every log_interval-th step)
            "logged_steps": len(steps),
            "mean_step_ms": 1e3 * sum(m["duration_step"] for m in steps) / len(steps) if steps else None,
            "mean_label_tok_s": sum(m["tokens_per_second_per_gpu"] for m in steps) / len(steps) if steps else None,
            "final_loss": steps[-1]["loss"] if steps else None,
            "final_dev_loss": dev[-1] if dev else None,
        },
        "wer_bf16": parity["bf16"]["wer"],
        "wer_int8": parity["int8"]["wer"],
        "int8_wer_delta": delta,
        "int8_within_acceptance": delta <= 0.1,
        "decode_tok_s": speeds,
        "spelling_map_sha256": parity["bf16"]["spelling_map_sha256"],
        "spelling_map_entries": parity["bf16"]["spelling_map_entries"],
        "seed": SEED,
        "stage_seconds": seconds,
        "wall_s": time.time() - t_start,
        "launch_counts": launches,
        "recipe": "python -m ssi_tpu_torch.wer_drive  # deterministic: same seed -> same corpus/codebook",
    }
    (art / "summary.json").write_text(json.dumps(summary, indent=2) + "\n")
    LOGGER.info(json.dumps(summary, indent=2))
    return summary


def _device_desc(device: str) -> str:
    """The card's name and power limit as nvidia-smi reports them, or "cpu"."""
    if device == "cpu":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


if __name__ == "__main__":
    logging.basicConfig(
        format="[%(asctime)s][wer_drive][%(levelname)s] - %(message)s",
        level=logging.INFO,
        stream=sys.stdout,
    )
    main()
