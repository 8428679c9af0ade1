"""The port's generation entry point (``ssi_tpu_torch.generate.run_generation``)
against the JAX package's ``run_generation`` on the same tiny fp32 checkpoint
and JSON-lines split, composed from ``conf/generate.yaml`` with the WER
drive's overrides (``tools/wer_drive.py``), greedy."""

import json
from pathlib import Path

import pytest

from tests import helpers

REPO = Path(__file__).resolve().parent.parent
N_ROWS = 6


@pytest.fixture(scope="module", autouse=True)
def restore_logging():
    """Both CLIs apply the conf job-logging config (a console and a file
    handler on the root logger); the module leaves the root logger as it was."""
    import logging

    root = logging.getLogger()
    level, handlers = root.level, list(root.handlers)
    yield
    for handler in root.handlers:
        if handler not in handlers:
            handler.close()
    root.handlers = handlers
    root.setLevel(level)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """A tiny extended checkpoint under ``<root>/experiments/run/checkpoints/step_0``
    and a JSON-lines test split."""
    root = tmp_path_factory.mktemp("gen")
    model_dir = helpers.make_tiny_hf_checkpoint(root / "experiments" / "run" / "checkpoints" / "step_0")
    rows = helpers.synthetic_sft_rows(N_ROWS)
    split = root / "test.jsonl"
    split.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return root, model_dir, split, rows


def overrides(model_dir: Path, split: Path, out_root: Path | None, *extra: str) -> list[str]:
    out = [
        f"model={model_dir}",
        f"experiments_root_dir={model_dir.parents[2]}",
        f"tokenizer.path={model_dir / 'original' / 'tokenizer.model'}",
        "model_config=tiny_test",
        f"speech.n_dsus={helpers.TINY_N_DSUS}",
        "data=sft/mls-hubert_large_ll60k-layer_22",
        "data.test.dataset.source=json",
        f"+data.test.dataset.data_files={split}",
        "data.test.dataset.split=train",
        "gen.split=test",
        "batch_size=4",
        "sampling_params.max_tokens=8",
        "dtype=fp32",
        "observability=false",
        "+device=cpu",
    ]
    if out_root is not None:
        out.append(f"gen.output_dir={out_root}")
    return out + list(extra)


def port_cfg(*args, **kw):
    from ssi_tpu_torch.config import compose

    return compose(REPO / "conf", "generate", overrides=overrides(*args, **kw))


def read_records(out_dir: Path) -> list[dict]:
    return [json.loads(line) for line in (out_dir / "generations.jsonl").read_text().splitlines()]


def jax_generate(assets, out_root: Path, *extra: str) -> Path:
    """The JAX package's run on the same split (its dataset loader reads the
    same rows; the JAX side needs no network or ``datasets`` cache)."""
    import datasets as hfd

    import ssi_tpu.data as data_mod
    from ssi_tpu.config import compose
    from ssi_tpu.generate import run_generation

    _, model_dir, split, rows = assets
    mp = pytest.MonkeyPatch()
    mp.setattr(data_mod, "load_hf_dataset", lambda source, **kw: hfd.Dataset.from_list(rows))
    try:
        return run_generation(compose(REPO / "conf", "generate", overrides=overrides(model_dir, split, out_root, *extra)))
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def jax_run(assets, tmp_path_factory):
    out_root = tmp_path_factory.mktemp("jax_out")
    return out_root, jax_generate(assets, out_root)


@pytest.fixture(scope="module")
def port_run(assets, tmp_path_factory):
    from ssi_tpu_torch.generate import run_generation

    root, model_dir, split, _ = assets
    out_root = tmp_path_factory.mktemp("port_out")
    return out_root, run_generation(port_cfg(model_dir, split, out_root))


def assert_float_close(a, b, what: str) -> None:
    assert (a is None) == (b is None), what
    if a is not None:
        assert abs(a - b) <= 1e-5 * max(abs(b), 1e-6), f"{what}: {a} vs {b}"


def test_generations_equal_jax_line_for_line(jax_run, port_run):
    (_, jax_dir), (_, port_dir) = jax_run, port_run
    assert port_dir.relative_to(port_run[0]) == jax_dir.relative_to(jax_run[0]) == Path("json") / "test"
    assert_generations_equal(jax_dir, port_dir)


def assert_generations_equal(jax_dir: Path, port_dir: Path, n: int = 1) -> None:
    """Every record of the port's ``generations.jsonl`` equals the JAX
    package's: key order, ``n`` outputs each, log-probabilities within 1e-5
    relative, every other field byte-equal."""
    jax_lines = (jax_dir / "generations.jsonl").read_text().splitlines()
    port_lines = (port_dir / "generations.jsonl").read_text().splitlines()
    assert len(port_lines) == len(jax_lines) == N_ROWS
    for lj, lp in zip(jax_lines, port_lines):
        rj, rp = json.loads(lj), json.loads(lp)
        assert list(rp) == list(rj)  # key order
        assert len(rp["outputs"]) == len(rj["outputs"]) == n
        for oj, op in zip(rj["outputs"], rp["outputs"]):
            assert list(op) == list(oj)
            # float log-probabilities summed in two frameworks: held to 1e-5 relative
            assert_float_close(op.pop("cumulative_logprob"), oj.pop("cumulative_logprob"), "cumulative_logprob")
            lpj, lpp = oj.pop("logprobs"), op.pop("logprobs")
            assert (lpp is None) == (lpj is None)  # the dense engine reports none
            assert len(lpp or ()) == len(lpj or ())
            for a, b in zip(lpp or (), lpj or ()):
                assert_float_close(a, b, "logprobs")
        # every other field byte-equal
        assert json.dumps(rp, ensure_ascii=False) == json.dumps(rj, ensure_ascii=False)
    assert any(json.loads(line)["outputs"][0]["token_ids"] for line in port_lines)


def test_generations_read_by_the_wer_helper_as_jax_reads_them(jax_run, port_run):
    from ssi_tpu.utils import extract_texts_from_generations_jsonl as jax_extract
    from ssi_tpu_torch.utils import extract_texts_from_generations_jsonl

    port_file = port_run[1] / "generations.jsonl"
    assert extract_texts_from_generations_jsonl(port_file) == jax_extract(port_file) == \
        jax_extract(jax_run[1] / "generations.jsonl")


def test_config_snapshot_equal_jax(jax_run, port_run):
    (jax_root, jax_dir), (port_root, port_dir) = jax_run, port_run
    j = (jax_dir / "generation_config.yaml").read_text().replace(str(jax_root), "<out>")
    p = (port_dir / "generation_config.yaml").read_text().replace(str(port_root), "<out>")
    assert p == j
    assert not (port_dir / "_ckpt_scratch").exists() and not (jax_dir / "_ckpt_scratch").exists()


def test_second_run_refuses_to_overwrite(assets, port_run):
    from ssi_tpu_torch.generate import run_generation

    _, model_dir, split, _ = assets
    with pytest.raises(FileExistsError):
        run_generation(port_cfg(model_dir, split, port_run[0]))


def test_speculative_config_path_gives_the_same_tokens(assets, jax_run, tmp_path):
    from ssi_tpu_torch.generate import run_generation

    _, model_dir, split, _ = assets
    out_dir = run_generation(port_cfg(model_dir, split, tmp_path, "speculate_k=3"))
    spec = [r["outputs"][0]["token_ids"] for r in read_records(out_dir)]
    assert spec == [r["outputs"][0]["token_ids"] for r in read_records(jax_run[1])]


def test_null_output_dir_resolves_under_generations(assets, tmp_path):
    """``gen.output_dir=null`` maps .../checkpoints/step_0 to .../generations/step_0
    (as the JAX ``resolve_gen_output_dir``); observability adds per-record metrics."""
    from ssi_tpu.config import Config as JaxConfig
    from ssi_tpu.generate import resolve_gen_output_dir as jax_resolve
    from ssi_tpu_torch.generate import last_run_stats, resolve_gen_output_dir, run_generation

    root, model_dir, split, _ = assets
    cfg = port_cfg(model_dir, split, None, "observability=true", "sampling_params.max_tokens=2")
    expected = resolve_gen_output_dir(cfg)
    jax_cfg = JaxConfig({"model": str(model_dir), "experiments_root_dir": str(root / "experiments")})
    assert expected == jax_resolve(jax_cfg)
    out_dir = run_generation(cfg)
    assert out_dir == Path(expected) / "json" / "test"
    records = read_records(out_dir)
    assert len(records) == N_ROWS and all(r["metrics"]["batch_generated_tokens"] > 0 for r in records)
    assert {"load_s", "load_bytes", "tokenize_s", "warmup_s", "generate_s"} <= set(last_run_stats)


def test_n_3_generations_equal_jax_line_for_line(assets, tmp_path):
    """``sampling_params.n=3`` (greedy): one record per prompt with 3 outputs
    (the engine's prompt-major order), equal to the JAX entry point's line for
    line; the engine takes the default pipeline depth, 2, as the JAX one does."""
    from ssi_tpu_torch.generate import run_generation

    _, model_dir, split, _ = assets
    jax_dir = jax_generate(assets, tmp_path / "jax", "sampling_params.n=3")
    port_dir = run_generation(port_cfg(model_dir, split, tmp_path / "port", "sampling_params.n=3"))
    assert_generations_equal(jax_dir, port_dir, n=3)
    for record in read_records(port_dir):
        assert len({tuple(o["token_ids"]) for o in record["outputs"]}) == 1  # greedy siblings agree
        assert [o["index"] for o in record["outputs"]] == [0, 1, 2]


@pytest.mark.parametrize(
    "extra, match",
    [
        (["tensor_parallel=2"], r"^tensor_parallel=2 needs a world of 2 ranks, one device each \(this one has 1\): "
                                r"launch with torchrun --nproc_per_node 2$"),
    ],
    ids=["extra0-A9"],
)
def test_options_not_ported_raise_naming_their_item(assets, tmp_path, extra, match):
    """``tensor_parallel=2`` runs (A9's serving half: the case below), but
    only in a world of 2 ranks: in one process it raises, naming the
    launcher, before any output (the JAX ``make_mesh`` device-count check in
    the port's terms)."""
    from ssi_tpu_torch.generate import run_generation

    _, model_dir, split, _ = assets
    with pytest.raises(ValueError, match=match):
        run_generation(port_cfg(model_dir, split, tmp_path, *extra))
    assert not any(tmp_path.iterdir())  # refused before any output


@pytest.mark.parametrize("tp", [2, 4])
def test_tensor_parallel_generations_equal_jax_line_for_line(assets, tmp_path, tp):
    """``python -m torch.distributed.run --standalone --nproc_per_node N -m
    ssi_tpu_torch.cli.generate ... tensor_parallel=N +device=cpu`` (gloo
    ranks; at tp 4 the vocabulary 530 stays whole and so does attention over
    2 kv heads) writes the ``generations.jsonl`` of the JAX package's
    ``tensor_parallel=N`` run on the virtual CPU devices, line for line, and
    only rank 0 writes."""
    import os
    import subprocess
    import sys

    _, model_dir, split, _ = assets
    jax_dir = jax_generate(assets, tmp_path / "jax", f"tensor_parallel={tp}")
    env = {k: v for k, v in os.environ.items() if k != "SSI_TPU_COMPILE_CACHE"}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(tp),
                           "-m", "ssi_tpu_torch.cli.generate",
                           *overrides(model_dir, split, tmp_path / "port", f"tensor_parallel={tp}")],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    port_dir = tmp_path / "port" / "json" / "test"
    assert_generations_equal(jax_dir, port_dir)
    assert sorted(p.name for p in port_dir.iterdir()) == sorted(p.name for p in jax_dir.iterdir())


def test_cli_refuses_without_cuda_unless_device_cpu(assets, tmp_path):
    import torch

    from ssi_tpu_torch.cli.generate import main

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; this checks the no-GPU refusal")
    _, model_dir, split, _ = assets
    args = [a for a in overrides(model_dir, split, tmp_path / "a") if a != "+device=cpu"]
    with pytest.raises(RuntimeError, match=r"\+device=cpu"):
        main(args)
    assert not (tmp_path / "a").exists()
    main(args + ["+device=cpu"])
    assert len(read_records(tmp_path / "a" / "json" / "test")) == N_ROWS
