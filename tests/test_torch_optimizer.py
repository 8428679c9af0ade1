"""The port's AdamW, gradient clipping and learning-rate schedules against
the JAX package (``ssi_tpu/train/optimizer.py``, ``lr_schedule.py``), and the
copied constants and helpers against their originals. Inputs from numpy
seeds; AdamW over 5 steps within 1e-6 relative, schedules over steps 0-200
within 1e-7."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssi_tpu import constants as jax_constants
from ssi_tpu.train import lr_schedule as jax_sched
from ssi_tpu.train import optimizer as jax_opt
from ssi_tpu.utils import round_up as jax_round_up
from ssi_tpu_torch import constants
from ssi_tpu_torch.train import lr_schedule as sched
from ssi_tpu_torch.train.optimizer import (
    AdamWConfig,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    init_opt_state,
    tree_leaves,
    tree_map,
)
from ssi_tpu_torch.utils import round_up


def test_copied_constants_match_jax():
    assert constants.CROSS_ENTROPY_IGNORE_IDX == jax_constants.CROSS_ENTROPY_IGNORE_IDX


@pytest.mark.parametrize("multiple", [1, 7, 64, 128])
def test_round_up_matches_jax(multiple):
    assert [round_up(n, multiple) for n in range(300)] == [jax_round_up(n, multiple) for n in range(300)]


def make_tree(rng):
    return {"b": {"c": rng.standard_normal(5).astype(np.float32)}, "a": rng.standard_normal((4, 3)).astype(np.float32)}


def to_torch(tree):
    return {k: to_torch(v) if isinstance(v, dict) else torch.from_numpy(v.copy()) for k, v in tree.items()}


def to_jax(tree):
    return {k: to_jax(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


def as_np(tree):
    return [np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32)) for x in tree]


@pytest.mark.parametrize("moments", ["f32_f32", "bf16_f32"])
def test_adamw_matches_jax_over_five_steps(moments):
    rng = np.random.default_rng(5)
    p0 = make_tree(rng)
    grads = [make_tree(rng) for _ in range(5)]
    mu_t, mu_j = (torch.float32, jnp.float32) if moments == "f32_f32" else (torch.bfloat16, jnp.bfloat16)
    cfg = AdamWConfig(lr=1e-2, mu_dtype=mu_t, nu_dtype=torch.float32)
    jcfg = jax_opt.AdamWConfig(lr=1e-2, mu_dtype=mu_j, nu_dtype=jnp.float32)

    params = to_torch(p0)
    state = init_opt_state(params, cfg)
    jparams = to_jax(p0)
    jstate = jax_opt.init_opt_state(jparams, jcfg)
    for g in grads:
        adamw_update(to_torch(g), state, params, 1e-2, cfg)
        jparams, jstate = jax_opt.adamw_update(to_jax(g), jstate, jparams, jnp.float32(1e-2), jcfg)
    assert state["count"] == int(jstate["count"]) == 5
    for got, want in ((params, jparams), (state["mu"], jstate["mu"]), (state["nu"], jstate["nu"])):
        for a, b in zip(as_np(tree_leaves(got)), as_np(jax.tree.leaves(want))):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    assert state["mu"]["a"].dtype == mu_t and state["nu"]["a"].dtype == torch.float32


def test_clip_and_global_norm_match_jax():
    rng = np.random.default_rng(6)
    tree = make_tree(rng)
    for max_norm in (0.5, 1e3):
        got = to_torch(tree)
        norm = clip_by_global_norm(got, max_norm)
        want, jnorm = jax_opt.clip_by_global_norm(to_jax(tree), max_norm)
        np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
        for a, b in zip(as_np(tree_leaves(got)), as_np(jax.tree.leaves(want))):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(float(global_norm(got)), float(jax_opt.global_norm(want)), rtol=1e-6)
    small = {"a": torch.tensor([0.3, 0.4])}
    clip_by_global_norm(small, 1.0)
    np.testing.assert_allclose(small["a"].numpy(), [0.3, 0.4], rtol=1e-6)


def test_stochastic_rounding_preserves_small_updates():
    """The contract of tests/test_ops.py's stochastic-rounding test: with bf16
    nu, round-to-nearest drops the 1e-3 feed against a stored 1.0; stochastic
    rounding stays at least as close to the exact 1.0, and is deterministic
    given the step counter."""

    def run(stochastic, steps=400):
        cfg = AdamWConfig(lr=0.0, b2=0.999, weight_decay=0.0, mu_dtype=torch.float32,
                          nu_dtype=torch.bfloat16, stochastic_rounding=stochastic)
        params = {"w": torch.ones(128)}
        state = init_opt_state(params, cfg)
        state["nu"]["w"].fill_(1.0)
        g = {"w": torch.ones(128)}
        for _ in range(steps):
            adamw_update(g, state, params, 0.0, cfg)
        return float(state["nu"]["w"].float().mean())

    rtn, sto = run(False), run(True)
    assert abs(sto - 1.0) <= abs(rtn - 1.0) + 0.02
    assert run(True) == run(True)


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("dim", [0, 1, 2])
def test_adamw_on_shards_is_bitwise_the_whole_leaf_update(dim, stochastic):
    """ZeRO-1 / FSDP's update: ``adamw_update`` on each of two slices of
    every leaf (``where``: the slice's place in the leaf) gives, bit for bit,
    the whole leaves' update over 3 steps, with bf16 moments and stochastic
    rounding on and off; with it on, the rounding is not round-to-nearest's
    (the control), so the noise is in play."""
    rng = np.random.default_rng(dim)
    shapes = {"w": (4, 6, 8), "b": {"c": (6, 8, 4)}}
    cfg = AdamWConfig(lr=1e-2, mu_dtype=torch.bfloat16, nu_dtype=torch.bfloat16, stochastic_rounding=stochastic)

    def tree(draw):
        return {"w": draw(shapes["w"]), "b": {"c": draw(shapes["b"]["c"])}}

    p0 = tree(lambda s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)))
    grads = [tree(lambda s: torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 1e-3)) for _ in range(3)]
    whole = {"w": p0["w"].clone(), "b": {"c": p0["b"]["c"].clone()}}
    state = init_opt_state(whole, cfg)
    full_shapes = [tuple(t.shape) for t in tree_leaves(whole)]
    for g in grads:
        adamw_update(g, state, whole, 1e-2, cfg)
    parts = []
    for r in range(2):
        def part(t):
            n = t.shape[dim] // 2
            return t.narrow(dim, r * n, n).clone()

        params = {"w": part(p0["w"]), "b": {"c": part(p0["b"]["c"])}}
        st = init_opt_state(params, cfg)
        where = [(shape, tuple(r * n // 2 if i == dim else 0 for i, n in enumerate(shape))) for shape in full_shapes]
        for g in grads:
            adamw_update({"w": part(g["w"]), "b": {"c": part(g["b"]["c"])}}, st, params, 1e-2, cfg, where=where)
        parts.append((params, st))
    for key in ("params", "mu", "nu"):
        got = [tree_leaves(p if key == "params" else st[key]) for p, st in parts]
        want = tree_leaves(whole if key == "params" else state[key])
        for i, w in enumerate(want):
            assert torch.equal(torch.cat([got[0][i], got[1][i]], dim=dim), w), (key, i)
    if stochastic:
        rtn = init_opt_state(p0, AdamWConfig(lr=1e-2, mu_dtype=torch.bfloat16, nu_dtype=torch.bfloat16))
        p_rtn = {"w": p0["w"].clone(), "b": {"c": p0["b"]["c"].clone()}}
        for g in grads:
            adamw_update(g, rtn, p_rtn, 1e-2, AdamWConfig(lr=1e-2, mu_dtype=torch.bfloat16, nu_dtype=torch.bfloat16))
        assert not torch.equal(rtn["mu"]["w"], state["mu"]["w"])


@pytest.mark.parametrize("stochastic", [False, True])
def test_adamw_on_zero1_slices_of_tp_slices_is_bitwise_the_whole_leaf_update(stochastic):
    """Tensor-parallel ZeRO-1 at dp 2 x tp 2: each of the 4 ranks updates
    its pieces (``StateLayout``: the tp slice, then the moments' dp slice of
    it; ``offsets`` says where each piece lies in the whole leaf) over 3
    steps; the pieces put back where the offsets say equal the whole leaves'
    update bit for bit, bf16 moments and stochastic rounding on and off. The
    layout covers a ``("tp", "dp")`` co-sharded dimension (``embed``), dp on
    a dimension of its own beside tp (``wq``, ``w_down``) and dp alone
    (``final_norm``)."""
    from ssi_tpu_torch.parallel import Mesh, StateLayout, shard, tp_shard

    shapes = {"embed": (8, 3), "final_norm": (6,), "layers": {"wq": (2, 6, 4), "w_down": (2, 4, 6)}}
    cfg = AdamWConfig(lr=1e-2, mu_dtype=torch.bfloat16, nu_dtype=torch.bfloat16, stochastic_rounding=stochastic)
    rng = np.random.default_rng(11)

    def tree(draw):
        return {"embed": draw(shapes["embed"]), "final_norm": draw(shapes["final_norm"]),
                "layers": {k: draw(v) for k, v in shapes["layers"].items()}}

    p0 = tree(lambda s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)))
    grads = [tree(lambda s: torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 1e-3)) for _ in range(3)]
    whole = tree_map(lambda t: t.clone(), p0)
    state = init_opt_state(whole, cfg)
    for g in grads:
        adamw_update(g, state, whole, 1e-2, cfg)
    got = {key: tree_map(torch.zeros_like, whole) for key in ("params", "mu", "nu")}
    for rank in range(4):
        mesh = Mesh(dp=2, tp=2, rank=rank)
        layout = StateLayout.build(mesh, shapes, zero1=True, fsdp=False, num_kv_heads=2)
        if rank == 0:
            assert layout.tp == {"embed": 0, "final_norm": None, "layers": {"wq": 2, "w_down": 1}}
            assert layout.moments == {"embed": 0, "final_norm": 0, "layers": {"wq": 0, "w_down": 0}}
            assert layout.params == {"embed": None, "final_norm": None, "layers": {"wq": None, "w_down": None}}

        def piece(t, spec, dim):
            return shard(tp_shard(t, spec, mesh), dim, mesh)

        params = {k: piece(t, layout.specs[k], layout.moments[k]) for k, t in p0.items() if k != "layers"}
        params["layers"] = {k: piece(t, layout.specs["layers"][k], layout.moments["layers"][k])
                            for k, t in p0["layers"].items()}
        st = init_opt_state(params, cfg)
        offsets = layout.offsets(layout.moments)
        where = [None if o is None else (s, o) for o, s in zip(tree_leaves(offsets), tree_leaves(shapes))]
        for g in grads:
            part = {k: piece(t, layout.specs[k], layout.moments[k]) for k, t in g.items() if k != "layers"}
            part["layers"] = {k: piece(t, layout.specs["layers"][k], layout.moments["layers"][k])
                              for k, t in g["layers"].items()}
            adamw_update(part, st, params, 1e-2, cfg, where=where)
        for key, mine in (("params", params), ("mu", st["mu"]), ("nu", st["nu"])):
            for dst, src, off in zip(tree_leaves(got[key]), tree_leaves(mine), tree_leaves(offsets)):
                view = dst
                for d, (o, n) in enumerate(zip(off, src.shape)):
                    view = view.narrow(d, o, n)
                view.copy_(src)
    for key in ("params", "mu", "nu"):
        want = tree_leaves(whole if key == "params" else state[key])
        for i, (a, w) in enumerate(zip(tree_leaves(got[key]), want)):
            assert torch.equal(a, w), (key, i)


SCHEDULES = {
    "constant": (lambda m: m.constant_schedule(3e-4)),
    "cosine": (lambda m: m.cosine_schedule_with_warmup(3e-4, 20, 180)),
    "cosine_2_cycles": (lambda m: m.cosine_schedule_with_warmup(1e-3, 0, 150, num_cycles=2.0)),
    "wsd": (lambda m: m.wsd_schedule(3e-4, 10, 200, decay_fraction=0.2, min_lr_ratio=0.1)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_jax(name):
    ours, theirs = SCHEDULES[name](sched), SCHEDULES[name](jax_sched)
    got = np.array([ours(s) for s in range(201)])
    want = np.array([float(theirs(s)) for s in range(201)])
    assert all(isinstance(ours(s), float) for s in (0, 7))
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-7 * float(np.max(want)))
