"""The port's weight-only int8 (``ssi_tpu_torch/generate/quant.py``) against the
JAX package's ``ssi_tpu/generate/quant.py`` on the CPU: ``q`` and ``scale``
bitwise, the product within 1e-6, the int8 ``PagedDecodeEngine`` token for
token with the JAX int8 engine (k 0, and k 2 with the prefix cache), the
contract of ``tests/test_paged_decode.py::test_int8_weight_only_decode``, and
``run_generation`` with ``quantize_weights=int8`` line for line with the JAX
entry point."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssi_tpu.generate import quant as jquant
from ssi_tpu.generate.engine import SamplingParams as JSamplingParams
from ssi_tpu.generate.paged_engine import PagedDecodeEngine as JPagedDecodeEngine
from ssi_tpu.models.llama3 import init_params
from ssi_tpu_torch.generate import quant
from ssi_tpu_torch.generate.engine import SamplingParams
from ssi_tpu_torch.models.llama3 import params_from_numpy
from tests import helpers
from tests.test_torch_generate import (  # noqa: F401  (fixtures)
    REPO,
    assert_float_close,
    assets,
    overrides,
    port_cfg,
    read_records,
    restore_logging,
)
from tests.test_torch_paged_engine import make_engine, no_leaks
from tests.test_torch_pipeline import slow_jax, slow_port


@pytest.fixture(scope="module")
def setup():
    cfg = helpers.tiny_config()
    jparams = init_params(cfg, jax.random.key(7), dtype=jnp.float32)
    return cfg, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


def seeded_weights(seed: int, shape=(3, 96, 40)) -> np.ndarray:
    """Stacked ``[L, in, out]`` weights with per-column scales spread over four
    decades, an all-zero column (the ``amax > 0`` branch) and a column whose
    values sit exactly at half-steps of its scale (round half to even)."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(shape) * rng.uniform(1e-3, 3.0, (1, 1, shape[2]))).astype(np.float32)
    w[:, :, 3] = 0.0
    step = np.float32(0.01)
    w[:, 0, 5] = 127 * step
    w[:, 1:shape[1], 5] = (np.arange(shape[1] - 1) - (shape[1] - 1) // 2 + 0.5).astype(np.float32) * step
    return w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_q_and_scale_bitwise_equal_jax(seed, dtype):
    w = seeded_weights(seed)
    jw = jnp.asarray(w).astype(dtype)
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    want = jax.jit(jquant._quantize)(jw)
    got = quant._quantize(tw)
    assert got["q"].dtype == torch.int8 and got["scale"].dtype == torch.bfloat16
    assert got["q"].shape == w.shape and got["scale"].shape == (w.shape[0], 1, w.shape[2])
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["scale"].float().numpy(), np.asarray(want["scale"].astype(jnp.float32)))
    # the inputs reach both branches: a zero column's scale is 1, and q is 0 there
    assert (got["scale"][:, 0, 3] == 1).all() and (got["q"][:, :, 3] == 0).all()
    if dtype == "float32":  # and half-steps, which round to even
        frac = w[:, 1:, 5] / (np.float32(127 * 0.01) * np.float32(1 / 127.0))
        assert (np.abs(frac - np.round(frac)) == 0.5).any()


def test_quantized_tree_matches_jax_and_keeps_embed_and_norms(setup):
    cfg, jparams, tparams = setup
    jq = jquant.quantize_layer_weights_int8(jparams)
    tq = quant.quantize_layer_weights_int8(tparams)
    assert tq["embed"] is tparams["embed"] and tq["final_norm"] is tparams["final_norm"]
    for name, leaf in tq["layers"].items():
        if name in quant._LAYER_MATMULS:
            assert set(leaf) == {"q", "scale"}
            np.testing.assert_array_equal(leaf["q"].numpy(), np.asarray(jq["layers"][name]["q"]))
            np.testing.assert_array_equal(leaf["scale"].float().numpy(),
                                          np.asarray(jq["layers"][name]["scale"].astype(jnp.float32)))
        else:
            assert leaf is tparams["layers"][name]
    assert tparams["layers"]["wq"].dtype == torch.float32  # the input is not changed


def test_matmul_matches_jax(setup):
    _, jparams, tparams = setup
    jq = jquant.quantize_layer_weights_int8(jparams)
    tq = quant.quantize_layer_weights_int8(tparams)
    x = np.random.default_rng(3).standard_normal((5, tparams["layers"]["wq"].shape[1])).astype(np.float32)
    for name in ("wq", "w_down"):
        xi = x if name == "wq" else np.random.default_rng(4).standard_normal(
            (5, tparams["layers"][name].shape[1])).astype(np.float32)
        want = np.asarray(jquant.matmul(jnp.asarray(xi), jax.tree.map(lambda a: a[1], jq["layers"][name])))
        got = quant.matmul(torch.from_numpy(xi), {k: t[1] for k, t in tq["layers"][name].items()}).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
        # a plain weight is x @ w
        plain = quant.matmul(torch.from_numpy(xi), tparams["layers"][name][1]).numpy()
        np.testing.assert_allclose(plain, xi @ np.asarray(jparams["layers"][name][1]), rtol=1e-6,
                                   atol=1e-6 * np.abs(plain).max())


def test_int8_weight_only_decode(setup):
    """The twin of tests/test_paged_decode.py::test_int8_weight_only_decode: the
    per-element dequantization bound, the product close to the exact one, the
    int8 engine end to end, and an unknown mode refused."""
    cfg, jparams, tparams = setup
    qparams = quant.quantize_layer_weights_int8(tparams)
    for name in ("wq", "w_down"):
        w = tparams["layers"][name].numpy()
        leaf = qparams["layers"][name]
        deq = leaf["q"].float().numpy() * leaf["scale"].float().numpy()
        amax = np.abs(w).max(axis=-2, keepdims=True)
        assert np.all(np.abs(w - deq) <= amax / 127.0 + 1e-6), name
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((3, tparams["layers"]["wq"].shape[1]))
                         .astype(np.float32))
    exact = x @ tparams["layers"]["wq"][0]
    approx = quant.matmul(x, {k: t[0] for k, t in qparams["layers"]["wq"].items()})
    np.testing.assert_allclose(approx.numpy(), exact.numpy(), atol=0.15, rtol=0.15)

    eng = make_engine(tparams, cfg, quantize="int8")
    assert eng.params["layers"]["wq"]["q"].dtype == torch.int8
    outs = eng.generate_batch([[1, 2, 3, 4, 5], [7, 8, 9]],
                              SamplingParams(temperature=0.0, max_tokens=6, stop_token_ids=()))
    assert all(len(o["token_ids"]) == 6 for o in outs)
    assert all(0 <= t < cfg.vocab_size for o in outs for t in o["token_ids"])
    assert no_leaks(eng)
    with pytest.raises(ValueError, match="quantize"):
        make_engine(tparams, cfg, quantize="fp8")


@pytest.mark.parametrize("k, prefix", [(0, False), (2, True)], ids=["k0", "k2-prefix-cache"])
def test_int8_engine_tokens_equal_jax_int8_engine(setup, k, prefix):
    """Greedy tokens of the port's int8 engine equal the JAX int8 engine's,
    token for token (gather attention, both at harvest depth 1); with
    ``speculate_k=2`` the prompts share a prefix, so the cache engages."""
    int8_parity(setup, k, prefix, depth=1)


@pytest.mark.parametrize("k, prefix", [(0, False), (2, True)], ids=["k0", "k2-prefix-cache"])
def test_int8_engine_tokens_equal_jax_int8_engine_at_depth_2(setup, k, prefix):
    """The same at the default depth 2, both engines' chunks unfinished until harvested."""
    int8_parity(setup, k, prefix, depth=2)


def int8_parity(setup, k, prefix, depth):
    cfg, jparams, tparams = setup
    rng = np.random.default_rng(21)
    shared = rng.integers(0, cfg.vocab_size, 16).tolist() if prefix else []
    prompts = [shared + rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in [5, 11, 17, 3, 9, 14]]
    engine = slow_port(make_engine(tparams, cfg, quantize="int8", speculate_k=k, pipeline_depth=depth))
    outs = engine.generate_batch(prompts, SamplingParams(temperature=0.0, max_tokens=12))
    jeng = slow_jax(JPagedDecodeEngine(jparams, cfg, pad_id=0, n_slots=4, page_size=8, prompt_bucket=8,
                                       max_context=64, chunk=4, attn_impl="gather", pipeline_depth=depth,
                                       quantize="int8", speculate_k=k))
    jouts = jeng.generate_batch(prompts, JSamplingParams(temperature=0.0, max_tokens=12))
    for i, (out, jout) in enumerate(zip(outs, jouts)):
        assert out["token_ids"] == jout["token_ids"], (k, i)
        assert out["cumulative_logprob"] == pytest.approx(jout["cumulative_logprob"], abs=1e-3)
    st, jst = engine.last_stats, jeng.last_stats
    assert st["tokens_out"] == jst["tokens_out"] == 6 * 12
    if k:
        assert st["verify_steps"] == jst["verify_steps"] > 0
    if prefix:
        assert st["cached_prompt_tokens"] == jst["cached_prompt_tokens"] > 0
    assert no_leaks(engine)


def test_run_generation_int8_writes_the_jax_generations(assets, tmp_path):
    """``quantize_weights=int8`` flows from the config into the engine, and the
    port's ``generations.jsonl`` equals the JAX entry point's line for line
    (log-probabilities within 1e-5 relative)."""
    import datasets as hfd

    import ssi_tpu.data as data_mod
    from ssi_tpu.config import compose as jcompose
    from ssi_tpu.generate import run_generation as jax_run_generation
    from ssi_tpu_torch.generate import run_generation

    _, model_dir, split, rows = assets
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(data_mod, "load_hf_dataset", lambda source, **kw: hfd.Dataset.from_list(rows))
        jax_dir = jax_run_generation(jcompose(REPO / "conf", "generate", overrides=overrides(
            model_dir, split, tmp_path / "jax", "quantize_weights=int8")))
    port_dir = run_generation(port_cfg(model_dir, split, tmp_path / "port", "quantize_weights=int8"))
    jax_lines = (jax_dir / "generations.jsonl").read_text().splitlines()
    port_lines = (port_dir / "generations.jsonl").read_text().splitlines()
    assert len(port_lines) == len(jax_lines) == len(rows)
    for lj, lp in zip(jax_lines, port_lines):
        rj, rp = json.loads(lj), json.loads(lp)
        for oj, op in zip(rj["outputs"], rp["outputs"]):
            assert_float_close(op.pop("cumulative_logprob"), oj.pop("cumulative_logprob"), "cumulative_logprob")
            for a, b in zip(op.pop("logprobs") or [], oj.pop("logprobs") or []):
                assert_float_close(a, b, "logprobs")
        assert json.dumps(rp, ensure_ascii=False) == json.dumps(rj, ensure_ascii=False)
    assert any(r["outputs"][0]["token_ids"] for r in read_records(port_dir))
    assert "quantize_weights: int8" in (port_dir / "generation_config.yaml").read_text()
