"""Selective rematerialization in the port's model (``ssi_tpu_torch/models/llama3.py``
``forward(remat=...)``) on the tiny config in f32 on the CPU.

Every policy gives the loss and gradients of ``remat="none"`` bit for bit (a
kept product is the one a recompute would give), and matches the JAX
package's ``forward`` + ``jax.grad`` under the same policy within 2e-5. The
backward's recompute skips the kept products (counted as matrix products run
while the gradients are taken), and ``save_qkv_mlp_attn`` hands the flash
forward's o and lse to the recompute, so the forward attention runs once per
layer (the flash Function on its plain CPU versions).
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from ssi_tpu.models import llama3 as jllama
from ssi_tpu.train import step as jstep
from ssi_tpu_torch.models import configs as tconfigs
from ssi_tpu_torch.models import llama3 as tllama
from ssi_tpu_torch.ops import flash_attention as tflash
from ssi_tpu_torch.train import step as tstep
from ssi_tpu_torch.train.optimizer import tree_leaves, tree_unflatten
from tests import helpers

B, S = 2, 24
POLICIES = tllama.REMAT_POLICIES
# the layer products (of 7) each policy keeps
KEPT = {"full": 0, "none": 0, "save_qkv": 3, "save_mlp": 2, "save_qkv_mlp": 5, "save_qkv_mlp_attn": 5}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jcfg = helpers.tiny_config()
    cfg = tconfigs.get_model_config("tiny_test")
    cfg.n_dsus, cfg.modality_tokens = jcfg.n_dsus, jcfg.modality_tokens
    jparams = jllama.init_params(jcfg, jax.random.key(5), dtype=jnp.float32)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = tokens.copy()
    labels[:, : S // 4] = -100
    # the second row packs two sequences
    segment_ids = np.ones((B, S), np.int32)
    segment_ids[1, S // 2:] = 2
    positions = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    positions[1, S // 2:] -= S // 2
    return jcfg, cfg, jparams, (tokens, labels, segment_ids, positions)


def port_grads(cfg, jparams, batch, remat):
    params = tllama.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    loss_fn = tstep.make_loss_fn(cfg, remat=remat, chunk_size=16)
    loss, _ = loss_fn(tree_unflatten(params, leaves), *(torch.from_numpy(x) for x in batch))
    return loss.detach(), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("remat", POLICIES)
def test_every_policy_gives_the_grads_of_none_bitwise(setup, remat):
    _, cfg, jparams, batch = setup
    loss0, grads0 = port_grads(cfg, jparams, batch, "none")
    loss, grads = port_grads(cfg, jparams, batch, remat)
    assert torch.equal(loss, loss0)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads0))


@pytest.mark.parametrize("remat", POLICIES)
def test_every_policy_matches_jax(setup, remat):
    jcfg, cfg, jparams, batch = setup
    jloss_fn = jstep.make_loss_fn(jcfg, attn_impl="xla", remat=remat, chunk_size=16)
    jbatch = tuple(jnp.asarray(x) for x in batch)
    jloss, jgrads = jax.value_and_grad(lambda p: jloss_fn(p, *jbatch)[0])(jparams)
    loss, grads = port_grads(cfg, jparams, batch, remat)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=2e-5)
    for got, want in zip(grads, jax.tree.leaves(jgrads)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5 * np.abs(want).max())


class _CountProducts(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            self.mm += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("remat", POLICIES)
def test_the_backward_recomputes_only_what_the_policy_drops(setup, remat):
    """Matrix products run while the gradients are taken: each layer's 7
    products give 14 (dx and dW), plus the recompute of the products a
    rematerialized layer does not keep, but for the last (``w_down``): no
    gradient reads its output, so the recompute does not form it."""
    _, cfg, jparams, batch = setup
    params = tllama.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    tokens = torch.from_numpy(batch[0])
    hidden = tllama.forward(tree_unflatten(params, leaves), tokens, cfg, remat=remat)
    with _CountProducts() as counter:
        torch.autograd.grad(hidden.square().sum(), leaves)
    recomputed = 0 if remat == "none" else 6 - KEPT[remat]
    assert counter.mm == cfg.num_layers * (14 + recomputed)


def test_attention_residuals_skip_the_forward_recompute(setup, monkeypatch):
    """With the flash Function as the attention (its plain versions on the
    CPU), ``save_qkv_mlp_attn`` runs the forward attention once per layer,
    the other checkpointed policies twice, and all give the grads of "none"."""
    _, cfg, jparams, batch = setup
    calls = {"n": 0}
    fwd = tflash.flash_attention_fwd

    def counting(*args, **kwargs):
        calls["n"] += 1
        return fwd(*args, **kwargs)

    monkeypatch.setattr(tflash, "flash_attention_fwd", counting)
    monkeypatch.setattr(tllama, "flash_attention_fwd", counting)
    monkeypatch.setattr(tllama, "dispatch_attention", tflash.flash_attention)
    monkeypatch.setattr(tllama, "_on_flash", lambda q: True)
    results = {}
    for remat in ("none", "save_qkv_mlp", "save_qkv_mlp_attn"):
        calls["n"] = 0
        results[remat] = port_grads(cfg, jparams, batch, remat), calls["n"]
    (loss0, grads0), _ = results["none"]
    assert [results[r][1] for r in results] == [cfg.num_layers, 2 * cfg.num_layers, cfg.num_layers]
    for remat in ("save_qkv_mlp", "save_qkv_mlp_attn"):
        (loss, grads), _ = results[remat]
        assert torch.equal(loss, loss0) and all(torch.equal(a, b) for a, b in zip(grads, grads0))


def test_unknown_policy_raises(setup):
    _, cfg, jparams, batch = setup
    with pytest.raises(ValueError, match="Unknown remat policy"):
        port_grads(cfg, jparams, batch, "save_everything")
