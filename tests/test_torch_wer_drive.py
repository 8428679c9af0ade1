"""The port's WER drive (``python -m ssi_tpu_torch.wer_drive``) against the JAX
drive (``tools/wer_drive.py``) on the CPU: the synthesized tokenizer, corpus
files and codebook byte-equal, the base checkpoint's files in the same
layout, the truncation guard agreeing, and the whole drive at ``tiny_test``
width with ``--smoke --device cpu``: every stage through the port's CLIs, both
precisions scored, a summary with the JAX drive's keys."""

import importlib.util
import json
import logging
import os
import subprocess
import sys
from pathlib import Path

import pytest

from ssi_tpu_torch import wer_drive as pdrive

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jdrive():
    """``tools/wer_drive.py`` loaded as a module, as ``tests/test_torch_tokenizer.py`` loads it."""
    root = logging.getLogger()
    level, handlers = root.level, list(root.handlers)
    try:
        spec = importlib.util.spec_from_file_location("wer_drive_for_drive_tests", REPO / "tools" / "wer_drive.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module
    finally:  # the script configures console logging when it is imported
        root.handlers = handlers
        root.setLevel(level)


def test_constants_equal(jdrive):
    assert pdrive.WORDS == jdrive.WORDS and len(pdrive.WORDS) == 313
    assert (pdrive.N_WORDS, pdrive.SEED, pdrive.BASE_VOCAB) == (jdrive.N_WORDS, jdrive.SEED, jdrive.BASE_VOCAB)


def test_base_tokenizer_byte_equal(tmp_path, jdrive):
    a, b = tmp_path / "j" / "tokenizer.model", tmp_path / "p" / "tokenizer.model"
    jdrive.build_base_tokenizer(a, jdrive.WORDS)
    pdrive.build_base_tokenizer(b, pdrive.WORDS)
    assert a.read_bytes() == b.read_bytes()
    assert len(b.read_text().splitlines()) == 128_000


@pytest.mark.parametrize("n_dsus, n_train, n_dev, n_test", [(5000, 40, 6, 9), (313, 3, 1, 2)])
def test_corpus_files_and_codebook_byte_equal(tmp_path, jdrive, n_dsus, n_train, n_dev, n_test):
    jcodes = jdrive.build_corpus(tmp_path / "j", n_dsus, n_train, n_dev, n_test)
    pcodes = pdrive.build_corpus(tmp_path / "p", n_dsus, n_train, n_dev, n_test)
    assert pcodes == jcodes
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "p").iterdir()) == \
        ["codebook.json", "dev.jsonl", "refs_test.jsonl", "test.jsonl", "train.jsonl"]
    for name in names:
        assert (tmp_path / "p" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name
    with pytest.raises(ValueError, match="words"):
        pdrive.build_corpus(tmp_path / "x", 312, 1, 1, 1)


def test_base_checkpoint_layout_equals_jax(tmp_path, jdrive):
    """The same files; the JSON files byte-equal; the same tensors by name,
    shape and dtype (the random values come from another generator)."""
    from safetensors.numpy import load_file

    jdrive.build_base_checkpoint(tmp_path / "j", "tiny_test")
    pdrive.build_base_checkpoint(tmp_path / "p", "tiny_test", "cpu")
    for rel in ("config.json", "generation_config.json", "original/params.json"):
        assert (tmp_path / "p" / rel).read_bytes() == (tmp_path / "j" / rel).read_bytes(), rel
    jw, pw = load_file(tmp_path / "j" / "model.safetensors"), load_file(tmp_path / "p" / "model.safetensors")
    assert {k: (v.shape, v.dtype) for k, v in pw.items()} == {k: (v.shape, v.dtype) for k, v in jw.items()}


def test_cut_to_base_vocab(tmp_path):
    path = tmp_path / "tokenizer.model"
    pdrive.build_base_tokenizer(path, pdrive.WORDS)
    pdrive.cut_to_base_vocab(path, "llama3_2_100m")
    assert len(path.read_text().splitlines()) == 128_000
    pdrive.cut_to_base_vocab(path, "tiny_test")
    lines = path.read_text().splitlines()
    assert len(lines) == 256 and lines[255].endswith(" 255")


def test_truncation_guard_agrees_with_jax(tmp_path, jdrive):
    """Both guards read the composed SFT config and tokenize the same rows:
    both pass at the drive's 160 and both raise where the longest row no
    longer fits."""
    from ssi_tpu_torch.extend import extend_tiktoken

    ext = tmp_path / "ext"
    tok = ext / "original" / "tokenizer.model"
    pdrive.build_base_tokenizer(tok, pdrive.WORDS)
    extend_tiktoken(5000, True, tok, tok)
    pdrive.build_corpus(tmp_path / "data", 5000, 300, 2, 2)
    model = ["model_config=llama3_2_100m", "base_model_name=Llama-3.2-100M"]
    data = pdrive.data_split_overrides(tmp_path / "data")
    for guard in (jdrive.assert_no_truncation, pdrive.assert_no_truncation):
        guard(ext, tmp_path / "data", 160, model, data)
        with pytest.raises(RuntimeError, match="max_seq_len=100"):
            guard(ext, tmp_path / "data", 100, model, data)


def test_drive_refuses_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; this checks the no-GPU refusal")
    with pytest.raises(RuntimeError, match="--device cpu"):
        pdrive.main(["--workdir", str(tmp_path / "wd"), "--smoke"])
    assert not (tmp_path / "wd").exists()


def test_smoke_drive_on_the_cpu_runs_every_stage(tmp_path):
    """``--smoke --device cpu`` at ``tiny_test`` width: assets, extension, SFT,
    generation in bf16 and int8 and scoring, each stage a subprocess of the
    port's CLI; the summary carries the JAX drive's keys, both WERs and the
    spelling-map fingerprint, and each CLI stage reported its launch counts
    (empty: the CPU runs the plain versions)."""
    art = tmp_path / "art"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "ssi_tpu_torch.wer_drive", "--workdir", str(tmp_path / "wd"),
         "--artifacts-dir", str(art), "--smoke", "--device", "cpu", "--model-config", "tiny_test",
         "--max-seq-len", "512", "--batch-size", "4", "--grad-accum", "1", "--decode-slots", "8"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    summary = json.loads((art / "summary.json").read_text())
    jax_keys = {"pipeline", "hardware", "model", "corpus", "train", "wer_bf16", "wer_int8", "int8_wer_delta",
                "int8_within_acceptance", "decode_tok_s", "spelling_map_sha256", "spelling_map_entries", "seed",
                "recipe"}
    assert jax_keys <= set(summary)
    assert summary["hardware"] == "cpu" and summary["seed"] == pdrive.SEED
    assert summary["corpus"]["n_train"] == 256 and summary["train"]["max_steps"] == 8
    for tag in ("bf16", "int8"):
        assert 0.0 <= summary[f"wer_{tag}"] < float("inf")
        parity = json.loads((art / f"wer_parity_{tag}.json").read_text())
        assert parity["wer"] == summary[f"wer_{tag}"] and parity["n_samples"] == 16
        assert summary["decode_tok_s"][tag] > 0
    assert summary["spelling_map_entries"] == 2017
    assert summary["int8_wer_delta"] == abs(summary["wer_int8"] - summary["wer_bf16"])
    assert set(summary["stage_seconds"]) == {"assets", "extend", "train", "generate_bf16", "generate_int8",
                                             "score_bf16", "score_int8"}
    assert summary["launch_counts"] == {s: {} for s in ("train", "generate_bf16", "generate_int8",
                                                        "score_bf16", "score_int8")}
    assert summary["train"]["final_dev_loss"] is not None
    # the int8 run really served from int8 weights: its snapshot says so
    snap = (tmp_path / "wd" / "gen_int8" / "json" / "test" / "generation_config.yaml").read_text()
    assert "quantize_weights: int8" in snap and "device: cpu" in snap


def test_stage_commands_equal_the_jax_drives(tmp_path, jdrive, monkeypatch):
    """Every stage's arguments are the JAX drive's letter for letter: the
    same overrides for the extension, SFT, generation (bf16 and int8) and
    scoring, with ``python -m ssi_tpu_torch.cli.<name>`` where the JAX drive
    runs ``scripts/<name>.py``, and ``+device=cpu`` / ``--device cpu`` added
    only with ``--device cpu``."""
    step = tmp_path / "experiments" / "run" / "checkpoints" / "step_4000"
    step.mkdir(parents=True)
    argv = ["--workdir", str(tmp_path), "--phases", "extend,train,generate,score"]
    captured = {}
    for name, module in (("jax", jdrive), ("port", pdrive)):
        cmds = captured[name] = []
        monkeypatch.setattr(module, "run", lambda cmd, env, log_to=None, cmds=cmds: cmds.append(
            [str(c) for c in cmd]) or 0.0)
        monkeypatch.setattr(module, "assert_no_truncation", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", ["wer_drive.py", *argv])
    jdrive.main()
    pdrive.main([*argv, "--device", "cpu"])
    scripts = {"extend_llama3_2", "train_sft", "generate", "wer_parity"}
    assert len(captured["jax"]) == len(captured["port"]) == 6
    for jcmd, pcmd in zip(captured["jax"], captured["port"]):
        name = Path(jcmd[1]).stem
        assert name in scripts and pcmd[1:3] == ["-m", f"ssi_tpu_torch.cli.{name}"]
        extra = {"extend_llama3_2": ["--device", "cpu"], "wer_parity": []}.get(name, ["+device=cpu"])
        assert pcmd[3:] == jcmd[2:] + extra, name
