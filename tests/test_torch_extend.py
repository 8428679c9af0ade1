"""The port's extension CLI (``python -m ssi_tpu_torch.cli.extend_llama3_2``)
against ``scripts/extend_llama3_2.py`` on the same tiny base checkpoint (the
tiny architecture with its 256-byte tokenizer and no DSUs, fp32 weights from
a seed): the extended weights are bitwise equal, tensor for tensor, with the
same file metadata (the JAX package's native writer and the port's lay the
file out in different orders, each one a valid safetensors file), and
``config.json``, ``params.json``, ``generation_config.json``, the index and
``tokenizer.model`` are byte-equal."""

import importlib.util
import json
import logging
from argparse import Namespace
from pathlib import Path

import numpy as np
import pytest
import torch

from ssi_tpu_torch.checkpoint.safetensors_io import load_file, safe_open
from ssi_tpu_torch.cli import extend_llama3_2 as port_cli
from tests import helpers

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def restore_logging():
    """The JAX script configures the root logger when it is imported."""
    root = logging.getLogger()
    level, handlers = root.level, list(root.handlers)
    yield
    root.handlers = handlers
    root.setLevel(level)


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """A tiny *base* checkpoint as ``tools/wer_drive.py`` ``build_base_checkpoint``
    lays one out (bos/eos at 128,000/128,001, which the extension checks)."""
    import jax
    import jax.numpy as jnp
    from safetensors.numpy import save_file

    from ssi_tpu.checkpoint.convert import internal_to_hf
    from ssi_tpu.models.llama3 import init_params

    model_dir = tmp_path_factory.mktemp("extend") / "base"
    (model_dir / "original").mkdir(parents=True)
    cfg = helpers.tiny_config(0, False)
    params = init_params(cfg, jax.random.key(7), dtype=jnp.float32)
    hf = internal_to_hf(jax.device_get(params), cfg, xp=np)
    save_file({k: np.ascontiguousarray(v) for k, v in hf.items()}, str(model_dir / "model.safetensors"))
    config = {"architectures": ["LlamaForCausalLM"], "hidden_size": cfg.embed_dim, "num_hidden_layers": cfg.num_layers,
              "vocab_size": cfg.vocab_size, "bos_token_id": 128_000, "eos_token_id": 128_001,
              "tie_word_embeddings": True}
    (model_dir / "config.json").write_text(json.dumps(config, indent=2))
    (model_dir / "generation_config.json").write_text(json.dumps({"bos_token_id": 128_000, "eos_token_id": 128_001}))
    (model_dir / "original" / "params.json").write_text(json.dumps({"vocab_size": cfg.vocab_size}))
    (model_dir / "README.md").write_text("not copied")
    helpers.write_tiny_tokenizer(model_dir / "original" / "tokenizer.model")
    return model_dir


def jax_script():
    spec = importlib.util.spec_from_file_location("extend_llama3_2_script", REPO / "scripts" / "extend_llama3_2.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("n_new,sigma,modality", [(16, 1e-5, True), (40, 1.0, False)])
def test_extension_output_equals_the_jax_script(base, tmp_path, n_new, sigma, modality):
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    jax_script().main(Namespace(n_new_dsus=n_new, input_dir=base, output_dir=jax_out, model_config="tiny_test",
                                sigma_scaling=sigma, use_modality_tokens=modality))
    argv = ["--n_new_dsus", str(n_new), "--input_dir", str(base), "--output_dir", str(port_out),
            "--model-config", "tiny_test", "--sigma-scaling", str(sigma), "--device", "cpu"]
    port_cli.main(port_cli.parse_args(argv + ([] if modality else ["--no-modality-tokens"])))
    files = sorted(str(p.relative_to(jax_out)) for p in jax_out.rglob("*") if p.is_file())
    assert files == sorted(str(p.relative_to(port_out)) for p in port_out.rglob("*") if p.is_file())
    assert "README.md" not in files
    for name in files:
        if name.endswith(".safetensors"):
            j, p = load_file(jax_out / name), load_file(port_out / name)
            assert list(p) == list(j)
            assert all(p[k].dtype == j[k].dtype and torch.equal(p[k], j[k]) for k in j), name
            assert safe_open(port_out / name).metadata() == safe_open(jax_out / name).metadata() == {"format": "pt"}
        else:
            assert (port_out / name).read_bytes() == (jax_out / name).read_bytes(), name
    cfg = json.loads((port_out / "config.json").read_text())
    assert cfg["vocab_size"] == 512 + n_new + 2 * modality
    embed = load_file(next(port_out.glob("*.safetensors")))["model.embed_tokens.weight"]
    assert embed.shape[0] == cfg["vocab_size"]


def test_default_device_refuses_without_a_card(base, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = port_cli.parse_args(["--n_new_dsus", "4", "--input_dir", str(base), "--output_dir", str(tmp_path / "o")])
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_cli.main(args)
    assert not (tmp_path / "o").exists()
