"""The BPE-compressed DSU axis end to end on the CPU, the port against the JAX
package, on a tiny compressed checkpoint: ``make_tiny_hf_checkpoint``
extended by n_new rows, its ``tokenizer.model`` swapped for the base
tokenizer plus merges trained by the port's ``train_bpe`` (and the two
modality tokens), loaded with ``tokenizer.pattern: cl100k``.

Held: the embedding's 256 + n_new + 2 + 256 rows carried into both Trainers
and through ``params_from_numpy``; the CPT loaders' batches bitwise equal
(and fewer appended-range tokens than under the PUA pattern); CPT losses and dev losses within
2e-5 (f32) and ``n_tokens.dsu`` equal; the greedy generation CLI's records
equal line for line, and ``generate_sample --pattern cl100k`` equal to the
JAX script's record, both from the port's CPT checkpoint; the SFT and
serving entry points run with the pattern too.
"""

import copy
from itertools import groupby
import importlib.util
import json
import logging
from pathlib import Path
import sys

import numpy as np
import pytest
import torch

import ssi_tpu.data as jdata
import ssi_tpu.tokenizer as jtok
from ssi_tpu.config import Config as JaxConfig
from ssi_tpu.train import Trainer as JaxTrainer
from ssi_tpu_torch.config import Config as PortConfig
import ssi_tpu_torch.data as pdata
from ssi_tpu_torch.speech import dsu2pua
import ssi_tpu_torch.tokenizer as ptok
from ssi_tpu_torch.tokenizer.bpe_train import merge_into_tokenizer, train_bpe
from ssi_tpu_torch.train.trainer import Trainer
from tests import helpers
from tests.test_torch_generate import assert_generations_equal, read_records

REPO = Path(__file__).resolve().parent.parent
UNITS = 12  # raw DSU alphabet of the rows
N_CPT, N_GEN = 16, 6  # N_GEN: the rows assert_generations_equal expects


@pytest.fixture(scope="module", autouse=True)
def few_threads_and_logging():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    root = logging.getLogger()
    level, handlers = root.level, list(root.handlers)
    yield
    torch.set_num_threads(n)
    for handler in root.handlers:
        if handler not in handlers:
            handler.close()
    root.handlers = handlers
    root.setLevel(level)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """(root, step_0 dir, n_new, CPT rows and their file, SFT rows and their file)."""
    root = tmp_path_factory.mktemp("compressed")
    cpt = helpers.synthetic_cpt_rows(N_CPT, seed=3, n_dsus=UNITS)
    corpus = ["".join(dsu2pua(k) for k, _ in groupby(r["speech_tokens"])) for r in cpt]
    ranks = train_bpe(corpus, 48)
    base = helpers.write_tiny_tokenizer(root / "base" / "tokenizer.model")
    compressed = root / "compressed.model"
    n_new = merge_into_tokenizer(base, ranks, compressed, use_modality_tokens=True)
    step = helpers.make_tiny_hf_checkpoint(root / "experiments" / "run" / "checkpoints" / "step_0", n_dsus=n_new)
    (step / "original" / "tokenizer.model").write_bytes(compressed.read_bytes())
    sft = helpers.synthetic_sft_rows(N_GEN, n_dsus=UNITS)
    files = {}
    for name, rows in (("cpt", cpt), ("sft", sft)):
        files[name] = root / f"{name}.jsonl"
        files[name].write_text("".join(json.dumps(r) + "\n" for r in rows))
    return root, step, n_new, cpt, files["cpt"], sft, files["sft"]


def test_compressed_checkpoint_layout(assets):
    """bos/eos in config.json are the compressed tokenizer's dynamic specials;
    the embedding has 256 + n_new + 2 + 256 rows and reaches both packages'
    parameters (and ``params_from_numpy``) unchanged."""
    import jax
    import jax.numpy as jnp

    from ssi_tpu.checkpoint import Checkpointer as JaxCheckpointer
    from ssi_tpu.models.llama3 import init_params
    from ssi_tpu_torch.checkpoint import Checkpointer
    from ssi_tpu_torch.models.llama3 import params_from_numpy

    _, step, n_new, *_ = assets
    tok, special = ptok.setup_llama3_tokenizer(step / "original" / "tokenizer.model", verbose=False, pattern="cl100k")
    config = json.loads((step / "config.json").read_text())
    assert (config["bos_token_id"], config["eos_token_id"]) == (tok.bos_id, tok.eos_id) == \
        (special["<|begin_of_text|>"], special["<|end_of_text|>"])
    assert tok.base_vocab_size == 256 + n_new + 2
    cfg = helpers.tiny_config(n_dsus=n_new)
    assert cfg.vocab_size == config["vocab_size"] == tok.vocab_size == 256 + n_new + 2 + 256
    port = Checkpointer(step, output_dir=step.parent / "scratch_port",
                        model_expectations=cfg.checkpoint_expectations).load_params(cfg, torch.float32, "cpu")
    jax_params = JaxCheckpointer(step, output_dir=str(step.parent / "scratch_jax"),
                                 model_expectations=cfg.checkpoint_expectations).load_params(cfg, dtype=jnp.float32)
    assert port["embed"].shape == (cfg.vocab_size, cfg.embed_dim)
    assert np.array_equal(port["embed"].numpy(), np.asarray(jax_params["embed"]))
    fresh = jax.tree.map(np.asarray, init_params(cfg, jax.random.key(1), dtype=jnp.float32))
    carried = params_from_numpy(fresh, device="cpu")
    assert np.array_equal(carried["embed"].numpy(), fresh["embed"]) and carried["embed"].shape[0] == cfg.vocab_size


def cfg_dict(assets, out: Path, port: bool, **over) -> dict:
    root, step, n_new, _, cpt_file, _, _ = assets
    d = helpers.base_train_cfg_dict(step, root / out, kind="cpt")
    d["speech"]["n_dsus"] = d["data"]["n_dsus"] = n_new
    d["tokenizer"].update(max_seq_len=128, pattern="cl100k")
    d.update(max_steps=4, save_steps=4, eval_steps=2, remat="save_qkv_mlp", lr_scheduler=None)
    if port:
        d.update(attn_impl="auto", device="cpu")
        for name in ("train", "dev"):
            d["data"][name]["dataset"].update(source="json", data_files=str(cpt_file), split="train")
    d.update(copy.deepcopy(over))
    return d


@pytest.fixture(scope="module")
def jax_rows(assets):
    import datasets as hfd

    mp = pytest.MonkeyPatch()
    rows = assets[3]
    mp.setattr(jdata, "load_hf_dataset", lambda source, **kw: hfd.Dataset.from_list(rows))
    yield
    mp.undo()


def test_cpt_batches_bitwise_equal_and_compressed(assets, jax_rows):
    """``setup_text_completion_data`` with each package's tokenizer, under
    cl100k and under the PUA pattern: the same batches bit for bit; under
    cl100k the rows' DSU spans take fewer tokens of the appended range than
    under the PUA pattern (the same rows, the same spans). NB a modality
    codepoint glued to a DSU span is part of its piece under cl100k, and the
    tiny byte-level base holds no merge that reaches its bytes, so it encodes
    as 4 byte tokens there, as tiktoken encodes it."""
    _, step, *_ = assets
    path = step / "original" / "tokenizer.model"
    node = cfg_dict(assets, Path("unused"), port=False)["data"]["train"]
    pnode = cfg_dict(assets, Path("unused"), port=True)["data"]["train"]
    counts = {}
    for pattern in ("cl100k", None):
        jt = jtok.setup_llama3_tokenizer(path, max_seq_len=128, verbose=False, pattern=pattern)[0]
        pt = ptok.setup_llama3_tokenizer(path, max_seq_len=128, verbose=False, pattern=pattern)[0]
        j_loader, _ = jdata.setup_text_completion_data(JaxConfig(node), jt)
        p_loader, _ = pdata.setup_text_completion_data(PortConfig(json.loads(json.dumps(pnode))), pt)
        batches = list(zip(j_loader, p_loader, strict=True))
        assert batches
        for jb, pb in batches:
            assert list(pb) == list(jb)
            assert all(pb[k].dtype == jb[k].dtype and np.array_equal(pb[k], jb[k]) for k in jb)
        ds = p_loader.dataset
        n_new = assets[2]
        counts[pattern] = sum(sum(256 <= t < 256 + n_new for t in ds[i]["tokens"]) for i in range(len(ds)))
    assert 0 < counts["cl100k"] < counts[None]


def run(trainer_cls, cfg: dict):
    t = trainer_cls((PortConfig if trainer_cls is Trainer else JaxConfig)(cfg))
    t.setup()
    losses: list[float] = []
    t._loss_log = losses
    t.train()
    t.cleanup()
    return t, losses, list(t.metric_logger.history)


@pytest.fixture(scope="module")
def cpt_runs(assets, jax_rows):
    return (run(Trainer, cfg_dict(assets, Path("port_cpt"), port=True)),
            run(JaxTrainer, cfg_dict(assets, Path("jax_cpt"), port=False)))


def test_cpt_trainer_matches_jax(cpt_runs):
    (pt, p_losses, p_hist), (jt, j_losses, j_hist) = cpt_runs
    assert pt.tokenizer.pattern == jt.tokenizer.pattern == ptok.CL100K_PATTERN
    assert len(p_losses) == len(j_losses) == 4
    np.testing.assert_allclose(p_losses, j_losses, rtol=2e-5)
    p_dev = [r["dev_loss"] for r in p_hist if "dev_loss" in r]
    j_dev = [r["dev_loss"] for r in j_hist if "dev_loss" in r]
    assert len(p_dev) == len(j_dev) == 2
    np.testing.assert_allclose(p_dev, j_dev, rtol=2e-5)
    counts = lambda h: [{k: v for k, v in r.items() if k.startswith("n_tokens.") or k == "tokens_total"} for r in h]
    assert counts(p_hist) == counts(j_hist)
    assert dict(pt.token_type_counts_total) == dict(jt.token_type_counts_total)
    assert pt.token_type_counts_total["dsu"] > 0


def _gen_overrides(assets, step: Path, out: Path, *extra: str) -> list[str]:
    _, _, n_new, _, _, _, sft_file = assets
    return [f"model={step}", f"experiments_root_dir={step.parents[2]}",
            f"tokenizer.path={step / 'original' / 'tokenizer.model'}", "tokenizer.pattern=cl100k",
            "model_config=tiny_test", f"speech.n_dsus={n_new}", "data=sft/mls-hubert_large_ll60k-layer_22",
            "data.test.dataset.source=json", f"+data.test.dataset.data_files={sft_file}",
            "data.test.dataset.split=train", "gen.split=test", "batch_size=2", "sampling_params.max_tokens=8",
            "dtype=fp32", "observability=false", f"gen.output_dir={out}", *extra]


@pytest.fixture(scope="module")
def cpt_step(assets, cpt_runs):
    """The port's CPT checkpoint, laid out as a generation ``model=`` dir."""
    root = assets[0]
    step = root / "port_cpt" / "step_4"
    assert (step / "config.json").is_file() and (step / "original" / "tokenizer.model").is_file()
    return step


def test_generation_cli_equals_jax_line_for_line(assets, cpt_step, tmp_path):
    import datasets as hfd

    import ssi_tpu.config as jconfig
    from ssi_tpu.generate import run_generation as jax_generation
    from ssi_tpu_torch.config import compose
    from ssi_tpu_torch.generate import run_generation

    rows = assets[5]
    port_dir = run_generation(compose(REPO / "conf", "generate",
                                      overrides=_gen_overrides(assets, cpt_step, tmp_path / "port", "+device=cpu")))
    mp = pytest.MonkeyPatch()
    mp.setattr(jdata, "load_hf_dataset", lambda source, **kw: hfd.Dataset.from_list(rows))
    try:
        jax_dir = jax_generation(jconfig.compose(REPO / "conf", "generate",
                                                 overrides=_gen_overrides(assets, cpt_step, tmp_path / "jax")))
    finally:
        mp.undo()
    assert len(read_records(port_dir)) == N_GEN
    assert_generations_equal(jax_dir, port_dir)
    tok = ptok.setup_llama3_tokenizer(cpt_step / "original" / "tokenizer.model", verbose=False, pattern="cl100k")[0]
    for record in read_records(port_dir):
        ids = record["outputs"][0]["token_ids"]
        assert ids and record["outputs"][0]["text"] == tok.decode(ids)


def test_generate_sample_cl100k_equals_jax(assets, cpt_step, tmp_path):
    spec = importlib.util.spec_from_file_location("generate_sample_script", REPO / "scripts" / "generate_sample.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    argv = ["--model", str(cpt_step), "--n_dsus", str(assets[2]), "--model_config", "tiny_test", "--dtype", "fp32",
            "--max_tokens", "8", "--pattern", "cl100k", "--template", "repeat_this_modality_switch",
            "--speech_tokens", "3", "3", "7", "1", "4", "1", "--deduplicate"]
    saved = sys.argv
    try:
        sys.argv = ["generate_sample.py", *argv, "--jsonl_out", str(tmp_path / "jax.jsonl")]
        script.main(script.parse_args())
    finally:
        sys.argv = saved
    from ssi_tpu_torch.cli.generate_sample import main, parse_args

    main(parse_args([*argv, "--jsonl_out", str(tmp_path / "port.jsonl"), "--device", "cpu"]))
    j = json.loads((tmp_path / "jax.jsonl").read_text())
    p = json.loads((tmp_path / "port.jsonl").read_text())
    lp, lj = p["outputs"][0].pop("cumulative_logprob"), j["outputs"][0].pop("cumulative_logprob")
    assert abs(lp - lj) <= 1e-5 * abs(lj)
    assert p == j and p["outputs"][0]["token_ids"]


def test_sft_and_serving_entry_points_take_cl100k(assets, tmp_path, monkeypatch):
    """``python -m ssi_tpu_torch.cli.train_sft`` (2 steps) and
    ``python -m ssi_tpu_torch.cli.serve`` (the server it would serve, answering
    one greedy request for a compressed DSU prompt) with
    ``tokenizer.pattern=cl100k`` on the tiny compressed checkpoint."""
    import ssi_tpu_torch.serve as pserve
    from ssi_tpu_torch.cli.serve import main as serve_main
    from ssi_tpu_torch.cli.train_sft import main as sft_main

    _, step, n_new, _, _, _, sft_file = assets
    tok_path = step / "original" / "tokenizer.model"
    common = ["tokenizer.pattern=cl100k", f"speech.n_dsus={n_new}", "model_config=tiny_test", "dtype=fp32",
              f"tokenizer.path={tok_path}", "+device=cpu"]
    trainer = sft_main(["data=sft/mls-hubert_large_ll60k-layer_22", *common, f"checkpointer.checkpoint_dir={step}",
                        f"checkpointer.output_dir={tmp_path / 'sft'}", "tokenizer.max_seq_len=384",
                        "max_steps=2", "save_steps=2", "eval_steps=2", "wandb.enabled=false",
                        "gradient_accumulation_steps=1",
                        *[a for split in ("train", "dev") for a in (
                            f"data.{split}.dataset.source=json", f"+data.{split}.dataset.data_files={sft_file}",
                            f"data.{split}.dataset.split=train", f"data.{split}.dataloader.batch_size=2")]])
    assert trainer.tokenizer.pattern == ptok.CL100K_PATTERN and trainer.global_step == 2
    assert trainer.token_type_counts_total["dsu"] > 0

    answered = {}

    def serve_once(server, host, port):
        server.start()
        try:
            span = "".join(dsu2pua(k) for k in (3, 7, 1, 4, 1, 5))
            prompt = server.tokenizer.encode(span, add_eos=False)
            assert len(prompt) < 1 + len(span)  # the merges fired
            answered["outputs"] = server.submit(prompt, 4).outputs
        finally:
            server.stop()
        answered["pattern"] = server.tokenizer.pattern

    monkeypatch.setattr(pserve, "serve_forever", serve_once)
    serve_main([f"model={step}", *common, "batch_size=2", "max_cache_len=256", "server.port=0"])
    assert answered["pattern"] == ptok.CL100K_PATTERN
    assert len(answered["outputs"][0]["token_ids"]) == 4
