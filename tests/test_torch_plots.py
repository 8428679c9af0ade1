"""The port's plotting CLIs (``python -m ssi_tpu_torch.cli.plot_wandb_losses``
and ``python -m ssi_tpu_torch.cli.plt_embed_tsne``) against
``scripts/plot_wandb_losses.py`` and ``scripts/plt_embed_tsne.py``, loaded by
path on the CPU: the helpers return what the scripts' return, both write the
same images byte for byte from a synthesized run directory and a tiny
checkpoint, and the refusals (``--wandb``, and matplotlib, seaborn or
sklearn missing) name what they refuse."""

import importlib.util
import json
import logging
from pathlib import Path
import sys

import numpy as np
import pytest

import ssi_tpu.constants as jconst
import ssi_tpu_torch.cli.plot_wandb_losses as plosses
import ssi_tpu_torch.cli.plt_embed_tsne as ptsne
import ssi_tpu_torch.constants as pconst
from ssi_tpu_torch.models.configs import get_model_config
from ssi_tpu_torch.train.train_utils import get_token_type_ranges
from tests import helpers

REPO = Path(__file__).resolve().parent.parent


def _load_script(name: str):
    """A script loaded by path; the logging it configures at import is undone."""
    root = logging.getLogger()
    level, handlers = root.level, list(root.handlers)
    try:
        spec = importlib.util.spec_from_file_location(f"{name}_for_tests", REPO / "scripts" / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module
    finally:
        root.handlers = handlers
        root.setLevel(level)


@pytest.fixture(scope="module")
def scripts():
    return _load_script("plot_wandb_losses"), _load_script("plt_embed_tsne")


@pytest.fixture()
def run_dir(tmp_path):
    """``<root>/myrun-id_abc123/`` with ``checkpoints/metrics.jsonl`` and ``generations/`` holding WER files."""
    run = tmp_path / "experiments" / "myrun-id_abc123"
    (run / "checkpoints").mkdir(parents=True)
    rng = np.random.default_rng(0)
    lines = []
    for step in range(1, 41):
        entry = {"step": step, "loss": float(3.0 * np.exp(-step / 15) + rng.uniform(0, 0.1)), "lr": 1e-3}
        if step % 10 == 0:
            entry["dev_loss"] = entry["loss"] + 0.2
        lines.append(json.dumps(entry))
    lines.insert(5, json.dumps({"step": 5, "dev_loss": None}))
    (run / "checkpoints" / "metrics.jsonl").write_text("\n".join(lines) + "\n\n")
    gens = run / "generations"
    for i, step in enumerate((10, 20, 40)):
        d = gens / f"step_{step}" / "mls-x" / "dev"
        d.mkdir(parents=True)
        (d / "wer.json").write_text(json.dumps({"wer": 0.5 / (i + 1)}))
    (gens / "global_step_30" / "mls-x" / "dev").mkdir(parents=True)
    (gens / "global_step_30" / "mls-x" / "dev" / "wer.json").write_text(json.dumps({"wer": 0.2}))
    (gens / "step_x" / "mls-x" / "dev").mkdir(parents=True)  # not a step number: a warning
    (gens / "step_50" / "mls-x" / "dev").mkdir(parents=True)
    (gens / "step_50" / "mls-x" / "dev" / "wer.json").write_text("{not json")
    return run


def test_wandb_defaults_copied():
    assert (pconst.WANDB_ENTITY_DEFAULT, pconst.WANDB_PROJECT_DEFAULT) == \
        (jconst.WANDB_ENTITY_DEFAULT, jconst.WANDB_PROJECT_DEFAULT)


def test_loss_plot_helpers_equal_the_script(scripts, run_dir, tmp_path):
    script, _ = scripts
    gens = run_dir / "generations"
    assert plosses.extract_run_info(gens) == script.extract_run_info(gens) == ("myrun", "abc123")
    for bad in (Path("x"), tmp_path / "plain" / "generations"):
        with pytest.raises(ValueError) as want:
            script.extract_run_info(bad)
        with pytest.raises(ValueError, match=str(want.value)):
            plosses.extract_run_info(bad)
    for dataset, split in (("mls-x", "dev"), ("mls-x", "test"), ("absent", "dev")):
        assert plosses.extract_wer_data(gens, dataset, split) == script.extract_wer_data(gens, dataset, split)
    assert [s for s, _ in plosses.extract_wer_data(gens, "mls-x")] == [10, 20, 30, 40]
    assert plosses.load_history_jsonl(run_dir) == script.load_history_jsonl(run_dir)
    (run_dir / "checkpoints" / "metrics.jsonl").rename(run_dir / "metrics.jsonl")
    assert plosses.load_history_jsonl(run_dir) == script.load_history_jsonl(run_dir)
    (run_dir / "metrics.jsonl").unlink()
    with pytest.raises(FileNotFoundError):
        plosses.load_history_jsonl(run_dir)


@pytest.mark.parametrize("ext", ["png", "svg"])
def test_loss_plot_cli_writes_the_script_images(scripts, run_dir, tmp_path, monkeypatch, ext):
    script, _ = scripts
    gens = run_dir / "generations"
    monkeypatch.setattr(sys, "argv", ["plot_wandb_losses.py", str(gens), str(tmp_path / "script"), "--ext", ext])
    script.main()
    plosses.main(plosses.parse_args([str(gens), str(tmp_path / "port"), "--ext", ext]))
    for scale in ("linear", "log"):
        port = (tmp_path / "port" / f"losses_{scale}.{ext}").read_bytes()
        assert len(port) > 1000
        if ext == "png":
            assert port == (tmp_path / "script" / f"losses_{scale}.{ext}").read_bytes()


@pytest.fixture(scope="module")
def tiny_step(tmp_path_factory):
    return helpers.make_tiny_hf_checkpoint(tmp_path_factory.mktemp("tsne") / "step_0")


def test_tsne_helpers_equal_the_script(scripts, tiny_step, tmp_path):
    import torch

    from ssi_tpu_torch.checkpoint.safetensors_io import save_file

    _, script = scripts
    embeddings = ptsne.load_embeddings(tiny_step)
    assert embeddings.dtype == np.float32 and np.array_equal(embeddings, script.load_embeddings(tiny_step))
    cfg = get_model_config("tiny_test").copy()
    ranges = get_token_type_ranges(cfg)
    for vocab in (embeddings.shape[0], embeddings.shape[0] + 7):
        labels, names = ptsne.create_token_type_labels(ranges, vocab)
        want_labels, want_names = script.create_token_type_labels(ranges, vocab)
        assert np.array_equal(labels, want_labels) and names == want_names
    save_file({"lm_head.weight": torch.zeros(2, 2)}, tmp_path / "model.safetensors")
    with pytest.raises(KeyError, match="embed_tokens"):
        script.load_embeddings(tmp_path)
    with pytest.raises(KeyError, match="embed_tokens"):
        ptsne.load_embeddings(tmp_path)


def test_tsne_cli_writes_the_script_images(scripts, tiny_step, tmp_path):
    _, script = scripts
    overrides = [f"checkpointer.checkpoint_dir={tiny_step}", "+model_config=tiny_test",
                 f"speech.n_dsus={helpers.TINY_N_DSUS}", "tsne.perplexities=[5]", "tsne.max_points=300",
                 "tsne.n_pca_components=16"]
    script.main([f"output_dir={tmp_path / 'script'}", *overrides])
    ptsne.main([f"output_dir={tmp_path / 'port'}", *overrides])
    for name in ("embeddings_tsne_perplexity_5.png", "embeddings_by_token_type.png"):
        port = (tmp_path / "port" / name).read_bytes()
        assert len(port) > 1000 and port == (tmp_path / "script" / name).read_bytes(), name


def test_refusals(run_dir, tiny_step, tmp_path, monkeypatch):
    gens = run_dir / "generations"
    with pytest.raises(NotImplementedError, match="W&B API over the network"):
        plosses.main(plosses.parse_args([str(gens), str(tmp_path / "w"), "--wandb"]))
    overrides = [f"checkpointer.checkpoint_dir={tiny_step}", "+model_config=tiny_test",
                 f"speech.n_dsus={helpers.TINY_N_DSUS}", "tsne.perplexities=[5]", "tsne.max_points=200"]
    for missing, modules in (("sklearn", ["sklearn", "sklearn.manifold", "sklearn.decomposition"]),
                             ("seaborn", ["seaborn"]), ("matplotlib", ["matplotlib", "matplotlib.pyplot"])):
        with monkeypatch.context() as m:
            for module in modules:
                m.setitem(sys.modules, module, None)
            with pytest.raises(ImportError, match=f"needs the package '{missing}'"):
                ptsne.main([f"output_dir={tmp_path / missing}", *overrides])
            if missing == "matplotlib":
                with pytest.raises(ImportError, match="Plotting the loss curves needs the package 'matplotlib'"):
                    plosses.main(plosses.parse_args([str(gens), str(tmp_path / "m")]))
