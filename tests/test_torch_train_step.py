"""The port's train step (``ssi_tpu_torch/train/step.py``) against the JAX
package's ``make_train_step`` on the tiny config in f32 on the CPU, with the
JAX parameters carried across by ``params_from_numpy``.

Held within 1e-5 relative: a window's ``loss_sum``, ``num_tokens``,
``grad_norm``, ``lr`` and its gradients before the update; within 1e-4: the
loss stream over three steps. Parameters after AdamW are not compared
elementwise: AdamW's first step moves each weight by about +-lr whatever the
size of its gradient, so float noise in a near-zero gradient can flip its
sign.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssi_tpu.models import llama3 as jllama
from ssi_tpu.train import lr_schedule as jsched
from ssi_tpu.train import optimizer as jopt
from ssi_tpu.train import step as jstep
from ssi_tpu_torch.models import configs as tconfigs
from ssi_tpu_torch.models.llama3 import params_from_numpy
from ssi_tpu_torch.train import lr_schedule as tsched
from ssi_tpu_torch.train import step as tstep
from ssi_tpu_torch.train.optimizer import AdamWConfig, init_opt_state, tree_leaves
from tests import helpers

A, B, S = 2, 2, 32
CHUNK = 16


def port_config(jcfg):
    cfg = tconfigs.get_model_config("tiny_test")
    cfg.n_dsus, cfg.modality_tokens, cfg.tied_embeddings = jcfg.n_dsus, jcfg.modality_tokens, jcfg.tied_embeddings
    assert cfg.vocab_size == jcfg.vocab_size
    return cfg


@pytest.fixture(scope="module")
def tied():
    jcfg = helpers.tiny_config()
    return jcfg, port_config(jcfg), jllama.init_params(jcfg, jax.random.key(3), dtype=jnp.float32)


@pytest.fixture(scope="module")
def untied():
    jcfg = helpers.tiny_config()
    jcfg.tied_embeddings = False
    return jcfg, port_config(jcfg), jllama.init_params(jcfg, jax.random.key(11), dtype=jnp.float32)


def make_window(seed, vocab, a=A, packed=False):
    """tokens/labels [a, B, S]: the first quarter of each row ignored, as SFT
    prompts are; with ``packed``, two segments per row and their positions."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, vocab, (a, B, S)).astype(np.int32)
    labels = tokens.copy()
    labels[..., : S // 4] = -100
    out = {"tokens": tokens, "labels": labels}
    if packed:
        cut = S // 2 + 3
        seg = np.ones((a, B, S), np.int32)
        seg[..., cut:] = 2
        pos = np.concatenate([np.arange(cut), np.arange(S - cut)]).astype(np.int32)
        out["segment_ids"] = seg
        out["positions"] = np.broadcast_to(pos, (a, B, S)).copy()
    return out


LR = 1e-3  # AdamW base lr; the schedules set the lr of each step


def jax_run(jcfg, jparams, windows, clip=1.0, schedule=("cosine", 1e-3, 2, 10)):
    opt = jopt.AdamWConfig(lr=LR, mu_dtype=jnp.float32, nu_dtype=jnp.float32)
    sched = (jsched.cosine_schedule_with_warmup(*schedule[1:]) if schedule[0] == "cosine"
             else jsched.constant_schedule(schedule[1]))
    step = jstep.make_train_step(jcfg, opt, sched, clip_grad_norm=clip, chunk_size=CHUNK, donate=False,
                                 remat=False)
    state = {"params": jparams, "opt_state": jopt.init_opt_state(jparams, opt), "step": jnp.zeros((), jnp.int32)}
    out = []
    for w in windows:
        state, m = step(state, *(jnp.asarray(w[k]) for k in ("tokens", "labels", "segment_ids", "positions") if k in w))
        out.append({k: np.asarray(v) for k, v in m.items()})
    return state, out


def port_state(tcfg, jparams):
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    opt = AdamWConfig(lr=LR, mu_dtype=torch.float32, nu_dtype=torch.float32)
    return {"params": params, "opt_state": init_opt_state(params, opt), "step": 0}, opt


def port_run(tcfg, jparams, windows, clip=1.0, schedule=("cosine", 1e-3, 2, 10), remat=True):
    state, opt = port_state(tcfg, jparams)
    sched = (tsched.cosine_schedule_with_warmup(*schedule[1:]) if schedule[0] == "cosine"
             else tsched.constant_schedule(schedule[1]))
    step = tstep.make_train_step(tcfg, opt, sched, clip_grad_norm=clip, chunk_size=CHUNK, remat=remat)
    out = []
    for w in windows:
        state, m = step(state, *(torch.from_numpy(w[k]) for k in ("tokens", "labels", "segment_ids", "positions")
                                 if k in w))
        out.append(m)
    return state, out


def check_metrics(got, want):
    for key in ("loss_sum", "grad_norm", "lr"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5, err_msg=key)
    assert int(got["num_tokens"]) == int(want["num_tokens"])
    assert bool(got["applied"]) == bool(want["applied"])


def window_grads_jax(jcfg, jparams, w):
    loss_fn = jstep.make_loss_fn(jcfg, remat=False, chunk_size=CHUNK)
    grads, ntok = None, 0
    for i in range(w["tokens"].shape[0]):
        args = [jnp.asarray(w[k][i]) for k in ("tokens", "labels", "segment_ids", "positions") if k in w]
        (_, n), g = jax.value_and_grad(loss_fn, has_aux=True)(jparams, *args)
        grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
        ntok += int(n)
    return [np.asarray(x) / max(ntok, 1) for x in jax.tree.leaves(grads)]


def window_grads_port(tcfg, jparams, w, remat=True):
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    loss_fn = tstep.make_loss_fn(tcfg, remat=remat, chunk_size=CHUNK)
    ntok = 0
    for i in range(w["tokens"].shape[0]):
        args = [torch.from_numpy(w[k][i]) for k in ("tokens", "labels", "segment_ids", "positions") if k in w]
        loss, n = loss_fn(params, *args)
        loss.backward()
        ntok += int(n)
    return [p.grad.numpy() / max(ntok, 1) for p in leaves]


def assert_grads_close(got, want, rtol):
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * float(np.abs(b).max()), err_msg=f"leaf {i}")


@pytest.mark.parametrize("packed", [False, True])
def test_one_window_matches_jax(tied, packed):
    jcfg, tcfg, jparams = tied
    w = make_window(0, jcfg.vocab_size, packed=packed)
    _, (want,) = jax_run(jcfg, jparams, [w])
    _, (got,) = port_run(tcfg, jparams, [w])
    check_metrics(got, want)
    assert_grads_close(window_grads_port(tcfg, jparams, w), window_grads_jax(jcfg, jparams, w), 1e-5)


@pytest.mark.parametrize("packed", [False, True])
def test_three_windows_loss_stream_matches_jax(tied, packed):
    jcfg, tcfg, jparams = tied
    windows = [make_window(s, jcfg.vocab_size, packed=packed) for s in (1, 2, 3)]
    jstate, want = jax_run(jcfg, jparams, windows)
    state, got = port_run(tcfg, jparams, windows)
    np.testing.assert_allclose([float(m["loss_sum"]) for m in got], [float(m["loss_sum"]) for m in want], rtol=1e-4)
    np.testing.assert_allclose([float(m["lr"]) for m in got], [float(m["lr"]) for m in want], rtol=1e-5)
    assert state["step"] == int(jstate["step"]) == 3


def test_shift_labels_match_jax():
    rng = np.random.default_rng(4)
    labels = rng.integers(0, 50, (3, 17)).astype(np.int32)
    seg = np.sort(rng.integers(1, 4, (3, 17)), axis=1).astype(np.int32)
    np.testing.assert_array_equal(tstep.shift_labels(torch.from_numpy(labels)).numpy(),
                                  np.asarray(jstep.shift_labels(jnp.asarray(labels))))
    np.testing.assert_array_equal(
        tstep.shift_labels_packed(torch.from_numpy(labels), torch.from_numpy(seg)).numpy(),
        np.asarray(jstep.shift_labels_packed(jnp.asarray(labels), jnp.asarray(seg))))


def test_zero_token_window_applies_nothing(tied):
    jcfg, tcfg, jparams = tied
    w = make_window(5, jcfg.vocab_size)
    w["labels"][:] = -100
    state, opt = port_state(tcfg, jparams)
    before = [p.clone() for p in tree_leaves(state["params"])]
    step = tstep.make_train_step(tcfg, opt, tsched.constant_schedule(1e-3), clip_grad_norm=1.0, chunk_size=CHUNK)
    state, m = step(state, torch.from_numpy(w["tokens"]), torch.from_numpy(w["labels"]))
    assert not bool(m["applied"]) and int(m["num_tokens"]) == 0 and float(m["loss_sum"]) == 0.0
    assert state["step"] == 0 and state["opt_state"]["count"] == 0
    for a, b in zip(tree_leaves(state["params"]), before):
        assert torch.equal(a, b)
    _, (want,) = jax_run(jcfg, jparams, [w], schedule=("constant", 1e-3))
    assert not bool(want["applied"])


def test_remat_full_gives_the_grads_of_none(tied):
    jcfg, tcfg, jparams = tied
    w = make_window(6, jcfg.vocab_size, packed=True)
    assert_grads_close(window_grads_port(tcfg, jparams, w, remat="full"),
                       window_grads_port(tcfg, jparams, w, remat="none"), 1e-6)
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        window_grads_port(tcfg, jparams, w, remat="save_qkv")


def test_untied_lm_head_receives_its_gradient(untied):
    jcfg, tcfg, jparams = untied
    w = make_window(7, jcfg.vocab_size, a=1)
    _, (want,) = jax_run(jcfg, jparams, [w], clip=None, schedule=("constant", 1e-3))
    state, (got,) = port_run(tcfg, jparams, [w], clip=None, schedule=("constant", 1e-3))
    assert np.isnan(float(got["grad_norm"])) and np.isnan(float(want["grad_norm"]))
    np.testing.assert_allclose(float(got["loss_sum"]), float(want["loss_sum"]), rtol=1e-5)
    p0 = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    new = state["params"]
    assert not torch.equal(new["lm_head"], p0["lm_head"])
    assert not torch.equal(new["embed"], p0["embed"])
    assert not torch.equal(new["lm_head"], new["embed"])
    assert_grads_close(window_grads_port(tcfg, jparams, w), window_grads_jax(jcfg, jparams, w), 1e-5)


def test_two_runs_from_one_seed_are_bitwise_equal(tied):
    jcfg, tcfg, jparams = tied
    windows = [make_window(s, jcfg.vocab_size) for s in (8, 9, 10)]
    runs = [[float(m["loss_sum"]) for m in port_run(tcfg, jparams, windows)[1]] for _ in range(2)]
    assert runs[0] == runs[1]


def test_token_counts_eval_and_dataset_loss_match_jax(tied):
    jcfg, tcfg, jparams = tied
    w = make_window(11, jcfg.vocab_size, a=1)
    w["tokens"][0, 0, -5:] = 0  # padding
    ranges = {"low": (1, 100), "high": (101, jcfg.vocab_size - 1)}
    got = tstep.count_token_types_device(torch.from_numpy(w["tokens"]), ranges, pad_id=0)
    want = jstep.count_token_types_device(jnp.asarray(w["tokens"]), ranges, pad_id=0)
    assert {k: int(v) for k, v in got.items()} == {k: int(v) for k, v in want.items()}

    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    batches = [{"tokens": make_window(s, jcfg.vocab_size, a=1)["tokens"][0],
                "labels": make_window(s, jcfg.vocab_size, a=1)["labels"][0]} for s in (12, 13)]
    got_loss = tstep.compute_dataset_loss(tstep.make_eval_step(tcfg, chunk_size=CHUNK), params, batches)
    want_loss = jstep.compute_dataset_loss(jstep.make_eval_step(jcfg, chunk_size=CHUNK), jparams, batches)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
