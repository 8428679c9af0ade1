"""The PyTorch port's model (RoPE, RMSNorm, forward, logits, parameter
carry-over) against the JAX reference on the tiny config, f32 on the CPU."""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssi_tpu.models import configs as jconfigs
from ssi_tpu.models import llama3 as jllama
from ssi_tpu.models import rope as jrope
from ssi_tpu_torch.generate import paged as tpaged
from ssi_tpu_torch.models import configs as tconfigs
from ssi_tpu_torch.models import llama3 as tllama
from ssi_tpu_torch.models import rope as trope
from tests import helpers


@pytest.fixture(scope="module")
def setup():
    cfg = helpers.tiny_config()
    jparams = jllama.init_params(cfg, jax.random.key(7), dtype=jnp.float32)
    tparams = tllama.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, jparams, tparams


@pytest.mark.parametrize("head_dim,scale_factor", [(64, 32.0), (16, 32.0), (64, 8.0), (64, 1.0)])
def test_rope_cos_sin_and_apply_match_jax(head_dim, scale_factor):
    rng = np.random.default_rng(0)
    pos = rng.integers(0, 4096, (3, 17)).astype(np.int32)
    jc, js = jrope.rope_cos_sin(jnp.asarray(pos), head_dim, scale_factor=scale_factor)
    tc, ts = trope.rope_cos_sin(torch.from_numpy(pos), head_dim, scale_factor=scale_factor)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    x = rng.standard_normal((3, 17, 4, head_dim)).astype(np.float32)
    want = np.asarray(jrope.apply_rope(jnp.asarray(x), jc, js))
    got = trope.apply_rope(torch.from_numpy(x), tc, ts).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3.0
    w = rng.standard_normal((64,)).astype(np.float32)
    want = np.asarray(jllama.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    got = tllama.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("batch,seq", [(2, 24), (1, 7)])
def test_forward_logits_match_jax(setup, batch, seq):
    cfg, jparams, tparams = setup
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    want = np.asarray(jllama.logits(jparams, jllama.forward(jparams, jnp.asarray(tokens), cfg, remat=False)))
    hidden = tllama.forward(tparams, torch.from_numpy(tokens), cfg)
    got = tllama.logits(tparams, hidden)
    assert got.dtype == torch.float32 and got.shape == (batch, seq, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    # the thin module is the same computation
    module_logits = tllama.Llama3(tparams, cfg)(torch.from_numpy(tokens))
    np.testing.assert_array_equal(module_logits.numpy(), got.numpy())


@pytest.mark.parametrize("name", sorted(jconfigs.MODEL_CONFIGS))
def test_port_configs_equal_jax_configs(name):
    """The port's config registry is a copy of the JAX one: same names, same
    fields, same derived head_dim and vocab_size."""
    assert sorted(tconfigs.MODEL_CONFIGS) == sorted(jconfigs.MODEL_CONFIGS)
    want, got = jconfigs.MODEL_CONFIGS[name], tconfigs.get_model_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.head_dim, got.vocab_size) == (want.head_dim, want.vocab_size)
    got.n_dsus, got.modality_tokens = 5000, True
    assert got.vocab_size == want.vocab_size + 5002
    assert tconfigs.MODEL_CONFIGS[name].n_dsus == 0  # get_model_config hands out a copy


def test_forward_segments_and_positions_match_jax(setup):
    cfg, jparams, tparams = setup
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (1, 32)).astype(np.int32)
    seg = np.concatenate([np.ones((1, 20)), np.full((1, 12), 2)], axis=1).astype(np.int32)
    pos = np.concatenate([np.arange(20), np.arange(12)])[None].astype(np.int32)
    want = np.asarray(jllama.forward(
        jparams, jnp.asarray(tokens), cfg, positions=jnp.asarray(pos), segment_ids=jnp.asarray(seg), remat=False
    ))
    got = tllama.forward(
        tparams, torch.from_numpy(tokens), cfg, positions=torch.from_numpy(pos), segment_ids=torch.from_numpy(seg)
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_params_from_numpy_bf16_untied_bitwise():
    """bf16 (ml_dtypes) leaves cross bitwise through the uint16 view; an
    untied lm_head is carried and used by logits."""
    cfg = helpers.tiny_config()
    cfg.tied_embeddings = False
    jparams = jllama.init_params(cfg, jax.random.key(3), dtype=jnp.bfloat16)
    tree = jax.tree.map(np.asarray, jparams)
    tparams = tllama.params_from_numpy(tree, device="cpu")
    assert "lm_head" in tparams and tparams["lm_head"].dtype == torch.bfloat16
    for key in ("embed", "lm_head", "final_norm"):
        np.testing.assert_array_equal(tparams[key].view(torch.int16).numpy(), tree[key].view(np.int16))
    for name, leaf in tree["layers"].items():
        np.testing.assert_array_equal(tparams["layers"][name].view(torch.int16).numpy(), leaf.view(np.int16))
    assert tllama.unembed(tparams) is tparams["lm_head"]
    h = np.random.default_rng(4).standard_normal((3, cfg.embed_dim)).astype(np.float32)
    want = np.asarray(jllama.logits(jparams, jnp.asarray(h, jnp.bfloat16)))
    got = tllama.logits(tparams, torch.from_numpy(h).to(torch.bfloat16)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("fn", [tllama.init_params, tllama.params_from_numpy, tpaged.init_pools])
def test_constructors_default_to_the_card(fn):
    """The port runs on the card unless the caller asks for the CPU."""
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_init_params_layout_matches_jax():
    cfg = helpers.tiny_config()
    jtree = jllama.init_params(cfg, jax.random.key(0), dtype=jnp.float32)
    tparams = tllama.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    assert set(tparams) == set(jtree) and set(tparams["layers"]) == set(jtree["layers"])
    for name, leaf in jtree["layers"].items():
        assert tuple(tparams["layers"][name].shape) == leaf.shape, name
        assert tparams["layers"][name].dtype == torch.float32
    again = tllama.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    assert torch.equal(again["layers"]["wq"], tparams["layers"]["wq"])  # seeded
