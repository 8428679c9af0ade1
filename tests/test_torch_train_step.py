"""The port's train step (``ssi_tpu_torch/train/step.py``) against the JAX
package's ``make_train_step`` on the tiny config in f32 on the CPU, with the
JAX parameters carried across by ``params_from_numpy``.

Held within 1e-5 relative: a window's ``loss_sum``, ``num_tokens``,
``grad_norm``, ``lr`` and its gradients before the update; within 1e-4: the
loss stream over three steps. Parameters after AdamW are not compared
elementwise: AdamW's first step moves each weight by about +-lr whatever the
size of its gradient, so float noise in a near-zero gradient can flip its
sign.

The bf16 tests (``test_bf16_window_arithmetic_matches_jax``) hold what a
window does after accumulation with bf16 parameters: see their docstring.
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
from ssi_tpu_torch.train import optimizer as topt
from ssi_tpu_torch.train import step as tstep
from ssi_tpu_torch.train.optimizer import AdamWConfig, init_opt_state, tree_leaves, tree_unflatten
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
    # the selective policies (once refused, naming ROADMAP A7) give the same grads too
    assert_grads_close(window_grads_port(tcfg, jparams, w, remat="save_qkv"),
                       window_grads_port(tcfg, jparams, w, remat="none"), 1e-6)


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


# ---- bf16 windows: the arithmetic after accumulation ----------------------

BF16_LR = 1e-3
# f32 tolerances, elementwise relative: a few ulp. The old bf16 arithmetic
# misses both by far more (its gradients round at 2**-9; its norm is off by
# 1-2e-5 at these shapes).
GRAD_RTOL = 4e-6
NORM_RTOL = 2e-6


def gradient_tables(jparams, a, seed):
    """Per leaf, a [a, *shape] f32 table of bf16-exact values: micro-batch
    i's gradient of that leaf (a different one per micro-batch)."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((a, *x.shape)).astype(jnp.bfloat16).astype(np.float32)
            for x in jax.tree.leaves(jparams)]


def injected_loss_jax(tables):
    tabs = [jnp.asarray(t) for t in tables]

    def loss_fn(params, tokens, labels, segment_ids=None, positions=None):
        i = tokens[0, 0]  # the micro-batch's index, planted by the test
        loss = sum(jnp.sum(p.astype(jnp.float32) * t[i]) for p, t in zip(jax.tree.leaves(params), tabs))
        return loss, jnp.sum(jstep.shift_labels(labels) != -100).astype(jnp.int32)

    return loss_fn


def injected_loss_port(tables):
    tabs = [torch.from_numpy(t) for t in tables]

    def loss_fn(params, tokens, labels, segment_ids=None, positions=None):
        i = int(tokens[0, 0])
        loss = sum(torch.sum(p.float() * t[i]) for p, t in zip(tree_leaves(params), tabs))
        return loss, (tstep.shift_labels(labels) != -100).sum().to(torch.int32)

    return loss_fn


def bf16_np(x):
    """A bf16 array or tensor -> f32 numpy (exact)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def misses(got, want, rtol):
    return not all(np.allclose(bf16_np(a), bf16_np(b), rtol=rtol, atol=0.0) for a, b in zip(got, want))


@pytest.mark.parametrize("a,accum_dtype", [(1, None), (2, "bf16")])
def test_bf16_window_arithmetic_matches_jax(a, accum_dtype, monkeypatch):
    """bf16 parameters, one window of A micro-batches (A 1: the gradients stay
    bf16; A 2: accumulated in bf16, ``grad_accum_dtype=bf16``, the repo's
    default): the port's step against JAX ``make_train_step(donate=False)``.

    The two frameworks' bf16 backward passes round at other places, so their
    raw gradients differ at bf16 noise, which would hide a rounding of the
    scaled gradients. Both steps therefore run one injected loss,
    sum(p.float() * W_i) over the leaves: its gradient is W_i rounded to bf16
    in both, and W_i is bf16-exact, so both accumulate the same bits and only
    the arithmetic after accumulation is compared. Held, with clip 1.0 active
    (norm above 1) and f32 moments: the gradients AdamW reads are f32 and each
    within ``GRAD_RTOL`` of the JAX step's ``g / denom`` clipped (the two
    norms sum in other orders, so the clip factors differ by a few f32 ulp);
    ``grad_norm`` within ``NORM_RTOL``; the moments after one AdamW step
    within ``GRAD_RTOL``; the bf16 parameters after it bitwise equal. Control: the old bf16 arithmetic
    (``g.div_(denom)`` and the clip in the gradient's dtype) on the same
    accumulated gradients misses the gradients' dtype and values, the norm
    and the moments. (The bf16 parameters cannot tell the two apart: AdamW's
    first step moves each weight by about +-lr whatever its gradient's size.)
    """
    jcfg = helpers.tiny_config()
    tcfg = port_config(jcfg)
    jparams = jllama.init_params(jcfg, jax.random.key(5), dtype=jnp.bfloat16)
    tables = gradient_tables(jparams, a, seed=20 + a)
    w = make_window(30 + a, jcfg.vocab_size, a=a)
    for i in range(a):
        w["tokens"][i, 0, 0] = i

    # JAX: the step itself, and its arithmetic spelled out on the same sums
    monkeypatch.setattr(jstep, "make_loss_fn", lambda *args, **kw: injected_loss_jax(tables))
    jopt_cfg = jopt.AdamWConfig(lr=BF16_LR, mu_dtype=jnp.float32, nu_dtype=jnp.float32)
    jtrain = jstep.make_train_step(jcfg, jopt_cfg, jsched.constant_schedule(BF16_LR), clip_grad_norm=1.0,
                                   donate=False, grad_accum_dtype=jnp.bfloat16)
    jstate = {"params": jparams, "opt_state": jopt.init_opt_state(jparams, jopt_cfg), "step": jnp.zeros((), jnp.int32)}
    jstate, jm = jtrain(jstate, jnp.asarray(w["tokens"]), jnp.asarray(w["labels"]))
    sums = [jnp.asarray(t[0]).astype(jnp.bfloat16) for t in tables]
    for i in range(1, a):
        sums = [s + jnp.asarray(t[i]).astype(jnp.bfloat16) for s, t in zip(sums, tables)]
    n_tokens = int(jm["num_tokens"])
    want_grads, want_norm = jopt.clip_by_global_norm([g / jnp.float32(n_tokens) for g in sums], 1.0)
    np.testing.assert_allclose(float(want_norm), float(jm["grad_norm"]), rtol=1e-6)
    assert float(want_norm) > 1.0  # the clip is active

    # the port: the step, with AdamW's gradient leaves read as it reads them
    monkeypatch.setattr(tstep, "make_loss_fn", lambda *args, **kw: injected_loss_port(tables))
    seen = {}
    update = tstep.adamw_update

    def spy(grads, opt_state, params, lr, cfg, *, denom=1.0, clip=1.0):
        seen["sums"] = [g.clone() for g in tree_leaves(grads)]
        seen["read"] = [topt.window_grad(g, denom, clip) for g in tree_leaves(grads)]
        return update(grads, opt_state, params, lr, cfg, denom=denom, clip=clip)

    monkeypatch.setattr(tstep, "adamw_update", spy)
    state, opt = port_state(tcfg, jparams)
    params0 = [p.clone() for p in tree_leaves(state["params"])]
    ttrain = tstep.make_train_step(tcfg, opt, tsched.constant_schedule(BF16_LR), clip_grad_norm=1.0,
                                   grad_accum_dtype=torch.bfloat16 if accum_dtype == "bf16" else torch.float32)
    state, m = ttrain(state, torch.from_numpy(w["tokens"]), torch.from_numpy(w["labels"]))
    assert int(m["num_tokens"]) == n_tokens and bool(m["applied"])
    assert all(torch.equal(s.float(), torch.from_numpy(bf16_np(g))) for s, g in zip(seen["sums"], sums))

    assert all(g.dtype == torch.float32 for g in seen["read"])
    assert not misses(seen["read"], want_grads, GRAD_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=NORM_RTOL)
    for name in ("mu", "nu"):
        assert not misses(tree_leaves(state["opt_state"][name]), jax.tree.leaves(jstate["opt_state"][name]), GRAD_RTOL)
    for got, want in zip(tree_leaves(state["params"]), jax.tree.leaves(jstate["params"])):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(bf16_np(got), bf16_np(want))

    # control: the old arithmetic in the gradients' dtype, on the same sums
    old = [g.clone().div_(float(n_tokens)) for g in seen["sums"]]
    params = tree_unflatten(state["params"], [p.clone() for p in params0])
    old_tree = tree_unflatten(params, old)
    old_norm = topt.clip_by_global_norm(old_tree, 1.0)
    old_opt = init_opt_state(params, opt)
    topt.adamw_update(old_tree, old_opt, params, BF16_LR, opt)
    assert all(g.dtype == torch.bfloat16 for g in old)
    assert misses(old, want_grads, GRAD_RTOL)
    assert not np.isclose(float(old_norm), float(jm["grad_norm"]), rtol=NORM_RTOL, atol=0.0)
    for name in ("mu", "nu"):
        assert misses(tree_leaves(old_opt[name]), jax.tree.leaves(jstate["opt_state"][name]), GRAD_RTOL)


@pytest.mark.parametrize("remat", ["none", "save_qkv_mlp"])
def test_a_step_leaves_no_reference_cycle_holding_tensors(tied, remat):
    """Once a train step returns, nothing it made waits for the garbage
    collector: ``tree_unflatten``'s recursive closure was a reference cycle
    that held a step's gradients (at 1B, 5 GB of f32 accumulators) until a
    collection ran."""
    import gc

    jcfg, tcfg, jparams = tied
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    opt = AdamWConfig(lr=1e-3)
    state = {"params": params, "opt_state": init_opt_state(params, opt), "step": 0}
    step = tstep.make_train_step(tcfg, opt, tsched.constant_schedule(1e-3), clip_grad_norm=1.0, remat=remat,
                                 chunk_size=CHUNK)
    w = make_window(8, jcfg.vocab_size)
    tokens, labels = torch.from_numpy(w["tokens"]), torch.from_numpy(w["labels"])
    state, _ = step(state, tokens, labels)
    gc.collect()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        state, _ = step(state, tokens, labels)
        gc.collect()
        held = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
    assert held == []
