"""The port at the head_dim-128 shapes of Llama 3.2 3B (24 q / 8 kv heads:
n_rep 3) and Llama 3.1 8B (32 / 8: n_rep 4, an untied ``lm_head``, rope
``scale_factor`` 8), cut to tiny widths (2 layers, 6 or 8 q heads of 128),
against the JAX package on the CPU in f32: the fused paged write + attend
(#8) and the multi-token verify (#9) against the Pallas kernels in interpret
mode, greedy engine tokens at ``speculate_k`` 0 and 2, one training window's
loss and gradients, and the generation entry point on a 2-shard checkpoint,
line for line. The flash-attention cases at these shapes are cases of
tests/test_torch_flash_attention.py and tests/test_torch_flash_backward.py."""

import json
from dataclasses import fields
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ssi_tpu.generate.engine import SamplingParams as JSamplingParams
from ssi_tpu.generate.paged_engine import PagedDecodeEngine as JPagedDecodeEngine
from ssi_tpu.generate.paged_pallas import WRITE_WIN, paged_attention_pallas, paged_attention_pallas_multi
from ssi_tpu.models import configs as jconfigs
from ssi_tpu.models.llama3 import init_params
from ssi_tpu_torch.generate.engine import SamplingParams
from ssi_tpu_torch.generate.paged_cuda import paged_attention_fused, paged_attention_multi_fused
from ssi_tpu_torch.models import configs as tconfigs
from ssi_tpu_torch.models.llama3 import params_from_numpy
from tests import helpers
from tests.test_torch_generate import assert_float_close
from tests.test_torch_paged import _fused_inputs, _multi_inputs
from tests.test_torch_paged_engine import make_engine, no_leaks
from tests.test_torch_pipeline import slow_jax, slow_port
from tests.test_torch_train_step import (
    assert_grads_close,
    check_metrics,
    jax_run as jax_train_run,
    make_window,
    port_run as port_train_run,
    window_grads_jax,
    window_grads_port,
)

TOL = 2e-5
REPO = Path(__file__).resolve().parent.parent

# the registry's 3B and 8B head layouts at tiny widths: head_dim 128 throughout
SHAPES = {
    "3b": dict(embed_dim=768, num_heads=6, num_kv_heads=2, intermediate_dim=256),
    "8b": dict(embed_dim=1024, num_heads=8, num_kv_heads=2, intermediate_dim=256, tied_embeddings=False,
               scale_factor=8),
}


def jax_config(shape: str):
    cfg = helpers.tiny_config()
    for name, value in SHAPES[shape].items():
        setattr(cfg, name, value)
    assert cfg.head_dim == 128
    return cfg


def port_config(jcfg):
    """The port's config with every field of the JAX one."""
    return tconfigs.ConfigLlama3_2(**{f.name: getattr(jcfg, f.name) for f in fields(tconfigs.ConfigLlama3_2)})


@pytest.fixture(scope="module")
def models():
    out = {}
    for i, shape in enumerate(SHAPES):
        jcfg = jax_config(shape)
        jparams = init_params(jcfg, jax.random.key(20 + i), dtype=jnp.float32)
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
        assert ("lm_head" in tparams) == (not jcfg.tied_embeddings)
        out[shape] = jcfg, jparams, port_config(jcfg), tparams
    return out


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_fused_write_attend_matches_pallas_interpret(shape):
    """#8's plain version (the wrapper on the CPU) against the Pallas kernel
    in interpret mode at head_dim 128, n_rep 3 or 4: attention within 2e-5,
    pools bitwise equal except the trash row."""
    cfg = jax_config(shape)
    kp, vp, q, k_new, v_new, phys, attn_lens, write_rows, active = _fused_inputs(cfg, seed=31)
    with pltpu.force_tpu_interpret_mode():
        want, kp_want, vp_want = paged_attention_pallas(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(phys), jnp.asarray(attn_lens),
            k_new=jnp.asarray(k_new), v_new=jnp.asarray(v_new), write_rows=jnp.asarray(write_rows), interpret=True,
        )
    tkp, tvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    got = paged_attention_fused(
        torch.from_numpy(q), tkp, tvp, torch.from_numpy(phys), torch.from_numpy(attn_lens),
        k_new=torch.from_numpy(k_new), v_new=torch.from_numpy(v_new), write_rows=torch.from_numpy(write_rows),
    )
    assert got.shape == (4, cfg.num_heads, 128)
    np.testing.assert_allclose(got.numpy()[active], np.asarray(want)[active], rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(tkp.numpy()[:-1], np.asarray(kp_want)[:-1])
    np.testing.assert_array_equal(tvp.numpy()[:-1], np.asarray(vp_want)[:-1])


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_multi_fused_matches_pallas_multi_interpret(shape):
    """#9's plain version against the Pallas multi-token kernel in interpret
    mode at head_dim 128, n_rep 3 or 4 (T 4: 12 or 16 query rows per kv
    head), with drafts spanning two 8-row windows, a page-crossing span and
    an inactive slot."""
    cfg = jax_config(shape)
    kp, vp, q, k_new, v_new, logical, hist, active, n_pages = _multi_inputs(cfg, seed=33)
    slots, t_q = q.shape[:2]
    ps, max_pages = kp.shape[1], logical.shape[1]
    base, trash = n_pages, kp.shape[0] - 1
    phys = (base + logical).astype(np.int32)
    g1 = (hist // WRITE_WIN) * WRITE_WIN
    g2 = g1 + WRITE_WIN
    l1 = np.take_along_axis(logical, np.clip(g1 // ps, 0, max_pages - 1)[:, None], 1)[:, 0]
    l2 = np.take_along_axis(logical, np.clip(g2 // ps, 0, max_pages - 1)[:, None], 1)[:, 0]
    row1 = np.where(active, base + l1, trash).astype(np.int32)
    row2 = np.where(active & (g2 <= hist + t_q - 1), base + l2, trash).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        want, kp_want, vp_want = paged_attention_pallas_multi(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(phys), jnp.asarray(hist),
            k_new=jnp.asarray(k_new), v_new=jnp.asarray(v_new), row_w1=jnp.asarray(row1), row_w2=jnp.asarray(row2),
            interpret=True,
        )
    pos = hist[:, None] + np.arange(t_q)[None, :]
    write_rows = np.where(active[:, None], base + np.take_along_axis(logical, pos // ps, 1), trash).astype(np.int32)
    tkp, tvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    got = paged_attention_multi_fused(
        torch.from_numpy(q), tkp, tvp, torch.from_numpy(phys), torch.from_numpy(hist),
        k_new=torch.from_numpy(k_new), v_new=torch.from_numpy(v_new), write_rows=torch.from_numpy(write_rows),
    )
    np.testing.assert_allclose(got.numpy()[active], np.asarray(want)[active], rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(tkp.numpy()[:-1], np.asarray(kp_want)[:-1])
    np.testing.assert_array_equal(tvp.numpy()[:-1], np.asarray(vp_want)[:-1])


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("k", [0, 2])
def test_engine_greedy_tokens_equal_jax(models, shape, k):
    """Greedy tokens of the port's engine (plain attention on the CPU) equal
    the JAX engine's (gather attention, both at harvest depth 1), with the
    same verify steps under speculation."""
    engine_parity(models, shape, k, depth=1)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("k", [0, 2])
def test_engine_greedy_tokens_equal_jax_at_depth_2(models, shape, k):
    """The same at the default depth 2, both engines' chunks unfinished until harvested."""
    engine_parity(models, shape, k, depth=2)


def engine_parity(models, shape, k, depth):
    jcfg, jparams, tcfg, tparams = models[shape]
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jcfg.vocab_size, int(n)).tolist() for n in (5, 11, 17, 3, 9, 14)]
    engine = slow_port(make_engine(tparams, tcfg, speculate_k=k, pipeline_depth=depth))
    outs = engine.generate_batch(prompts, SamplingParams(temperature=0.0, max_tokens=10))
    jeng = slow_jax(JPagedDecodeEngine(jparams, jcfg, pad_id=0, n_slots=4, page_size=8, prompt_bucket=8,
                                       max_context=64, chunk=4, attn_impl="gather", pipeline_depth=depth,
                                       speculate_k=k))
    jouts = jeng.generate_batch(prompts, JSamplingParams(temperature=0.0, max_tokens=10))
    for i, (out, jout) in enumerate(zip(outs, jouts)):
        assert out["token_ids"] == jout["token_ids"], (shape, k, i)
        assert len(out["token_ids"]) == 10
        assert out["cumulative_logprob"] == pytest.approx(jout["cumulative_logprob"], abs=1e-3)
    if k:
        assert engine.last_stats["verify_steps"] == jeng.last_stats["verify_steps"] > 0
    assert no_leaks(engine)


@pytest.mark.parametrize("packed", [False, True])
def test_train_window_matches_jax(models, packed):
    """One training window at the 3B shape: loss sum, token count, gradient
    norm, lr and the gradients within 1e-5 of the JAX step's (the tolerances
    of tests/test_torch_train_step.py)."""
    jcfg, jparams, tcfg, _ = models["3b"]
    w = make_window(7, jcfg.vocab_size, packed=packed)
    _, (want,) = jax_train_run(jcfg, jparams, [w])
    _, (got,) = port_train_run(tcfg, jparams, [w])
    check_metrics(got, want)
    assert_grads_close(window_grads_port(tcfg, jparams, w), window_grads_jax(jcfg, jparams, w), 1e-5)


# --- the generation entry point on a 2-shard checkpoint ------------------------------------------------

N_ROWS = 4
MODEL_CONFIG = "tiny_3b_shape"  # registered in both packages for the module's runs


def write_sharded_checkpoint(model_dir: Path, jcfg, n_shards: int) -> None:
    """An extended HF model dir of random f32 weights in ``n_shards``
    safetensors shards (the decoder layers split between them) and
    ``model.safetensors.index.json``, as Llama 3.2 3B ships."""
    from safetensors.numpy import save_file

    from ssi_tpu.checkpoint.convert import internal_to_hf
    from ssi_tpu.extend import extend_tiktoken

    (model_dir / "original").mkdir(parents=True, exist_ok=True)
    params = init_params(jcfg, jax.random.key(4), dtype=jnp.float32)
    hf = {k: np.ascontiguousarray(np.asarray(v)) for k, v in internal_to_hf(jax.device_get(params), jcfg, xp=np).items()}
    names = sorted(hf)
    weight_map = {}
    for i in range(n_shards):
        shard = f"model-{i + 1:05d}-of-{n_shards:05d}.safetensors"
        part = names[i::n_shards]
        save_file({k: hf[k] for k in part}, str(model_dir / shard))
        weight_map.update({k: shard for k in part})
    total = sum(v.nbytes for v in hf.values())
    (model_dir / "model.safetensors.index.json").write_text(
        json.dumps({"metadata": {"total_size": total}, "weight_map": weight_map}, indent=2))
    first_special = jcfg.base_vocab_size_txt + jcfg.n_dsus + 2 * jcfg.modality_tokens
    config = {
        "architectures": ["LlamaForCausalLM"], "model_type": "llama", "hidden_size": jcfg.embed_dim,
        "intermediate_size": jcfg.intermediate_dim, "num_hidden_layers": jcfg.num_layers,
        "num_attention_heads": jcfg.num_heads, "num_key_value_heads": jcfg.num_kv_heads,
        "vocab_size": jcfg.vocab_size, "bos_token_id": first_special, "eos_token_id": first_special + 1,
        "tie_word_embeddings": jcfg.tied_embeddings, "rope_theta": float(jcfg.rope_base),
        "max_position_embeddings": jcfg.max_seq_len,
    }
    (model_dir / "config.json").write_text(json.dumps(config, indent=2))
    (model_dir / "generation_config.json").write_text(
        json.dumps({"bos_token_id": first_special, "eos_token_id": first_special + 1}, indent=2))
    (model_dir / "original" / "params.json").write_text(json.dumps({"vocab_size": jcfg.vocab_size}, indent=2))
    tok_path = model_dir / "original" / "tokenizer.model"
    helpers.write_tiny_tokenizer(tok_path)
    extend_tiktoken(jcfg.n_dsus, jcfg.modality_tokens, tok_path, tok_path)


@pytest.fixture(scope="module")
def generations(tmp_path_factory):
    """The JAX package's and the port's ``run_generation`` on one 2-shard
    checkpoint of the 3B shape (registered as ``tiny_3b_shape``, 2 shards
    expected, in both registries) and one JSON-lines split."""
    import logging

    import datasets as hfd

    import ssi_tpu.data as data_mod
    from ssi_tpu.config import compose as jcompose
    from ssi_tpu.generate import run_generation as jrun
    from ssi_tpu_torch.config import compose as tcompose
    from ssi_tpu_torch.generate import run_generation as trun

    jcfg = jax_config("3b")
    jcfg.n_checkpoint_shards = 2
    root = tmp_path_factory.mktemp("gen_3b")
    model_dir = root / "experiments" / "run" / "checkpoints" / "step_0"
    write_sharded_checkpoint(model_dir, jcfg, 2)
    rows = helpers.synthetic_sft_rows(N_ROWS)
    split = root / "test.jsonl"
    split.write_text("".join(json.dumps(r) + "\n" for r in rows))

    def overrides(out_root):
        return [
            f"model={model_dir}", f"experiments_root_dir={root / 'experiments'}",
            f"tokenizer.path={model_dir / 'original' / 'tokenizer.model'}", f"model_config={MODEL_CONFIG}",
            f"speech.n_dsus={helpers.TINY_N_DSUS}", "data=sft/mls-hubert_large_ll60k-layer_22",
            "data.test.dataset.source=json", f"+data.test.dataset.data_files={split}",
            "data.test.dataset.split=train", "gen.split=test", "batch_size=4", "sampling_params.max_tokens=8",
            "dtype=fp32", "observability=false", "+device=cpu", f"gen.output_dir={out_root}",
        ]

    logger = logging.getLogger()
    saved = logger.level, list(logger.handlers)
    mp = pytest.MonkeyPatch()
    mp.setitem(jconfigs.MODEL_CONFIGS, MODEL_CONFIG, jcfg)
    mp.setitem(tconfigs.MODEL_CONFIGS, MODEL_CONFIG, port_config(jcfg))
    mp.setattr(data_mod, "load_hf_dataset", lambda source, **kw: hfd.Dataset.from_list(rows))
    try:
        jax_dir = jrun(jcompose(REPO / "conf", "generate", overrides=overrides(root / "jax_out")))
        port_dir = trun(tcompose(REPO / "conf", "generate", overrides=overrides(root / "port_out")))
    finally:
        mp.undo()
        for handler in logger.handlers:  # both CLIs add job-logging handlers to the root logger
            if handler not in saved[1]:
                handler.close()
        logger.handlers = saved[1]
        logger.setLevel(saved[0])
    return model_dir, jax_dir, port_dir


def test_checkpoint_has_two_shards(generations):
    model_dir, _, _ = generations
    shards = sorted(p.name for p in model_dir.glob("*.safetensors"))
    assert shards == ["model-00001-of-00002.safetensors", "model-00002-of-00002.safetensors"]


def test_generation_on_two_shards_equals_jax_line_for_line(generations):
    _, jax_dir, port_dir = generations
    jax_lines = (jax_dir / "generations.jsonl").read_text().splitlines()
    port_lines = (port_dir / "generations.jsonl").read_text().splitlines()
    assert len(port_lines) == len(jax_lines) == N_ROWS
    for lj, lp in zip(jax_lines, port_lines):
        rj, rp = json.loads(lj), json.loads(lp)
        for oj, op in zip(rj["outputs"], rp["outputs"]):
            # log-probabilities summed in two frameworks: held to 1e-5 relative, as tests/test_torch_generate.py
            assert_float_close(op.pop("cumulative_logprob"), oj.pop("cumulative_logprob"), "cumulative_logprob")
            lpj, lpp = oj.pop("logprobs"), op.pop("logprobs")
            assert len(lpp) == len(lpj)
            for x, y in zip(lpp, lpj):
                assert_float_close(x, y, "logprobs")
        assert json.dumps(rp, ensure_ascii=False) == json.dumps(rj, ensure_ascii=False)
    assert any(json.loads(line)["outputs"][0]["token_ids"] for line in port_lines)
