"""Tensor-parallel training in the port across real processes: gloo ranks
on the CPU, spawned as ``tests/test_torch_multiprocess.py`` spawns its
ranks, against the JAX package on a one-process mesh of the virtual CPU
devices. A world of ``dp * tp`` ranks is the JAX mesh ``(dp, tp)``; rank
``r`` holds tp index ``r % tp`` and dp index ``r // tp``.

Held:

- the loss and every gradient leaf at meshes (1, 2), (2, 2) and (1, 4)
  against the JAX ``make_loss_fn`` on the same mesh (``tests/test_parallel.py``'s
  inputs and tolerances: loss rel 1e-5, gradients rtol 1e-3 atol 2e-5), at
  (2, 2) also with ZeRO-1's reduce-scatter and FSDP's gathers, at (1, 2)
  also with an untied ``lm_head`` (8B's layout: the lookup and the loss
  read different vocabulary-split leaves); on each rank
  remat ``full`` and ``save_qkv_mlp`` give remat ``none``'s loss and
  gradients bit for bit (the recompute replays the tp collectives in one
  order on every rank). At (1, 4) the vocabulary 530 and the 2 kv heads do
  not split 4 ways: ``embed`` and attention stay whole, the MLP splits;
- the Megatron ops at world 2 (``copy_to_tp``: identity forward, summed
  gradient; ``reduce_from_tp``: summed forward, gradient passed through)
  and the vocab-parallel cross-entropy against the whole-vocabulary plain
  one (loss, dh, dE) with labels in each slice, in the other and ignored;
- in a world of one, the tp path's collectives are identities that issue
  no call, and the vocab-parallel loss is the whole plain loss bit for bit;
- the SFT CLI (``conf/sft.yaml``) at tp 2 and at dp2 x tp2 with ZeRO-1:
  the losses within rel 1e-5 of the JAX Trainer's on the same mesh at the
  same global batch, the ``step_4/`` weights within 2e-5 in relative norm
  (``tests/test_torch_multiprocess.py``'s limits), every rank's loss stream
  alike, two runs bitwise equal, ``step_4/`` byte for byte a one-process
  save of its tensors, and no dp collective of the port's code on the world
  group (the worker's ``CHECK_GROUPS``: each one called with ``group`` None
  or WORLD raises);
- the sharded optimizer state (DCP on a ``("tp", "dp")`` device mesh) saved
  at dp2 x tp1 resumes at dp1 x tp2 and the reverse, and the msgpack state
  of dp2 x tp2 (whole moments) at dp1 x tp2, each continuing the loss
  stream of the run it resumes within rel 1e-5.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ssi_tpu.data as jdata
from ssi_tpu.config import compose as jax_compose
from ssi_tpu.models.llama3 import init_params
from ssi_tpu.train import Trainer as JaxTrainer
from tests import helpers
from tests.test_parallel import _loss_and_grads
from tests.test_torch_multiprocess import assets  # noqa: F401  (the tiny checkpoint and split, a module fixture)
from tests.test_torch_multiprocess import _free_port, resume_args, run_ranks, sft_args, strip_timing, weights

REPO = Path(__file__).resolve().parent.parent

# One rank of the gradient check: argv = rank, world, dp, port, work dir.
# It runs the port's loss on its tp slices and dp rows for each mode and
# remat policy, sums the gradients over its dp column and gathers them whole
# on rank 0, which writes them. At world 2 it also holds the Megatron ops and
# the vocab-parallel cross-entropy.
_GRAD_WORKER = """
import json, sys
from pathlib import Path
import numpy as np
import torch
import torch.distributed as dist

rank, world, dp, port, work = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], Path(sys.argv[5])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
from ssi_tpu_torch.models.configs import get_model_config
from ssi_tpu_torch.models.llama3 import params_from_numpy
from ssi_tpu_torch.parallel import StateLayout, full_host_copy, make_mesh, shard_params
from ssi_tpu_torch.train.optimizer import tree_leaves, tree_map, tree_unflatten
from ssi_tpu_torch.train import step as tstep

cfg = get_model_config("tiny_test")
cfg.n_dsus, cfg.modality_tokens = 16, True
flat = np.load(work / "params.npz")
tree = {}
for key in flat.files:
    *path, leaf = key.split("/")
    node = tree
    for p in path:
        node = node.setdefault(p, {})
    node[leaf] = flat[key]
whole = params_from_numpy(tree, device="cpu")
data = np.load(work / "data.npz")
mesh = make_mesh(dp=dp, tp=world // dp)
rows = data["tokens"].shape[0] // dp
tokens, labels = (torch.from_numpy(data[k][mesh.dp_rank * rows:(mesh.dp_rank + 1) * rows]) for k in ("tokens", "labels"))
untied = {**whole, "lm_head": torch.from_numpy(np.load(work / "lm_head.npy"))}
out = {}
for mode in (["plain", "zero1", "fsdp"] if dp > 1 else ["plain", "untied"]):
    tree = untied if mode == "untied" else whole
    shapes = tree_map(lambda t: tuple(t.shape), tree)
    layout = StateLayout.build(mesh, shapes, zero1=mode != "plain", fsdp=mode == "fsdp", num_kv_heads=cfg.num_kv_heads)
    local = shard_params(mesh, layout.tp_slices(tree), layout.params)
    ref = None
    for remat in ("none", "full", "save_qkv_mlp"):
        loss_fn = tstep.make_loss_fn(cfg, remat=remat, chunk_size=64, shards=layout.fsdp_shards(),
                                     tp=layout.tensor_parallel())
        loss, n, grads = tstep._value_and_grad(loss_fn, local, tokens, labels)
        if ref is None:
            ref = (loss, grads)
            continue
        assert torch.equal(loss, ref[0]), (mode, remat)
        assert all(torch.equal(a, b) for a, b in zip(grads, ref[1])), (mode, remat)
    loss, n = tstep._all_reduce_counts([ref[0], n], mesh)
    grads = tstep.sync_grads(ref[1], layout)
    full = full_host_copy(tree_unflatten(local, grads), layout.moments, mesh, layout.tp)
    if rank == 0:
        out[mode] = {"loss": float(loss), "n": int(n), "grads": {f"{i}": g.numpy() for i, g in enumerate(tree_leaves(full))},
                     "local": [list(p.shape) for p in tree_leaves(local)]}
if world == 2 and dp == 1:
    from ssi_tpu_torch.constants import CROSS_ENTROPY_IGNORE_IDX as IGNORE
    from ssi_tpu_torch.ops.cross_entropy import fused_cross_entropy
    from ssi_tpu_torch.ops.cross_entropy_cuda import vocab_parallel_cross_entropy
    from ssi_tpu_torch.parallel import copy_to_tp, reduce_from_tp

    w = torch.tensor([1.0, 2.0, 3.0]) * (rank + 1)
    x = (torch.arange(3.0) + 10 * rank).requires_grad_()
    y = reduce_from_tp(x, mesh)
    (gx,) = torch.autograd.grad((y * w).sum(), x)
    x2 = x.detach().clone().requires_grad_()
    z = copy_to_tp(x2, mesh)
    (gz,) = torch.autograd.grad((z * w).sum(), x2)
    ops = {"reduce_fwd": y.tolist(), "reduce_bwd": gx.tolist(), "copy_fwd": z.tolist(), "copy_bwd": gz.tolist()}
    # the vocab-parallel loss against the whole-vocabulary plain one
    g = torch.Generator().manual_seed(5)
    h = torch.randn(40, 16, generator=g)
    e = torch.randn(30, 16, generator=g) * 0.5
    lab = torch.randint(0, 30, (40,), generator=g)
    lab[::5] = IGNORE
    lab[1:4] = torch.tensor([0, 14, 15])  # the first row of each slice and the last of the first
    hw, ew = h.clone().requires_grad_(), e.clone().requires_grad_()
    want = fused_cross_entropy(hw, ew, lab, 16)
    dh_w, de_w = torch.autograd.grad(want, (hw, ew))
    hr, er = h.clone().requires_grad_(), e[15 * rank:15 * (rank + 1)].clone().requires_grad_()
    got = vocab_parallel_cross_entropy(copy_to_tp(hr, mesh), er, lab, mesh, 16)
    dh, de = torch.autograd.grad(got, (hr, er))
    de_all = [torch.empty_like(de) for _ in range(world)]
    dist.all_gather(de_all, de)
    ops.update(ce_loss=[float(got), float(want)], ce_dh=float((dh - dh_w).abs().max()),
               ce_de=float((torch.cat(de_all) - de_w).abs().max()), ce_scale=float(de_w.abs().max()))
    out["ops"] = ops
if rank == 0:
    np.save(work / "out.npy", out, allow_pickle=True)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def grad_setup(tmp_path_factory):
    """The JAX parameters (``tests/test_parallel.py``'s key 0), batch and an
    untied output head."""
    cfg = helpers.tiny_config()
    work = tmp_path_factory.mktemp("tp_grads")
    params = init_params(cfg, jax.random.key(0), dtype=jnp.float32)
    flat = {}
    for k, leaf in params.items():
        for name, x in (leaf.items() if isinstance(leaf, dict) else [(None, leaf)]):
            flat[f"{k}/{name}" if name else k] = np.asarray(x)
    np.savez(work / "params.npz", **flat)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (8, 64)).astype(np.int32)
    labels = tokens.copy()
    labels[:, :3] = -100
    np.savez(work / "data.npz", tokens=tokens, labels=labels)
    # an untied output head (8B's layout) for the "untied" case: the lookup and the loss read different leaves
    lm_head = np.asarray(params["embed"]) * 0.5 + rng.standard_normal(params["embed"].shape).astype(np.float32) * 0.02
    np.save(work / "lm_head.npy", lm_head)
    return work, tokens, labels, params, lm_head


def jax_untied_loss_and_grads(params, lm_head, mesh_shape, tokens, labels):
    """``tests/test_parallel.py``'s ``_loss_and_grads`` with an ``lm_head`` leaf."""
    from ssi_tpu.parallel import batch_sharding, make_mesh, shard_params
    from ssi_tpu.train.step import make_loss_fn

    cfg = helpers.tiny_config()
    mesh = make_mesh(dp=mesh_shape[0], tp=mesh_shape[1])
    sharded = shard_params(mesh, {**params, "lm_head": jnp.asarray(lm_head)})
    loss_fn = make_loss_fn(cfg, attn_impl="xla", remat=False, chunk_size=64)
    grad_fn = jax.jit(jax.value_and_grad(lambda p, t, y: loss_fn(p, t, y)[0]))
    bsh = batch_sharding(mesh, accum_axis=False)
    loss, grads = grad_fn(sharded, jax.device_put(tokens, bsh), jax.device_put(labels, bsh))
    return float(loss), jax.device_get(grads)


def run_grad_ranks(work: Path, dp: int, tp: int) -> dict:
    world = dp * tp
    env = {k: v for k, v in os.environ.items() if k != "SSI_TPU_COMPILE_CACHE"}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", _GRAD_WORKER, str(r), str(world), str(dp), str(port), str(work)],
                              cwd=work, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"rank failed:\n{log[-4000:]}"
    return np.load(work / "out.npy", allow_pickle=True).item()


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2), (1, 4)])
def test_loss_and_grads_equal_the_jax_mesh(grad_setup, mesh_shape):
    work, tokens, labels, params, lm_head = grad_setup
    dp, tp = mesh_shape
    got = run_grad_ranks(work, dp, tp)
    want = {"plain": _loss_and_grads(mesh_shape, tokens, labels)}
    modes = ["plain", "zero1", "fsdp"] if dp > 1 else ["plain", "untied"]
    if "untied" in modes:
        want["untied"] = jax_untied_loss_and_grads(params, lm_head, mesh_shape, tokens, labels)
    assert sorted(k for k in got if k != "ops") == sorted(modes)
    for mode in modes:
        rec = got[mode]
        want_loss, want_grads = want.get(mode, want["plain"])
        leaves = [np.asarray(g) for g in jax.tree.leaves(want_grads)]
        assert rec["n"] == int((labels[:, 1:] != -100).sum())
        assert rec["loss"] == pytest.approx(want_loss, rel=1e-5), mode
        assert len(rec["grads"]) == len(leaves)
        for i, w in enumerate(leaves):
            np.testing.assert_allclose(rec["grads"][str(i)], w, rtol=1e-3, atol=2e-5, err_msg=f"{mode} leaf {i}")
    if "untied" in modes:  # sorted leaves: embed, final_norm, layers..., lm_head: both split by vocabulary rows
        assert got["untied"]["local"][0] == got["untied"]["local"][-1] == [530 // tp if 530 % tp == 0 else 530, 64]
    # rank 0's slices (sorted leaves: embed, final_norm, layers: attn_norm, mlp_norm, w_down, w_gate, w_up, wk, wo,
    # wq, wv); the embedding splits 2 ways (530 rows) and attention only where tp divides the 2 kv heads
    plain = got["plain"]["local"]
    split_v, split_attn = 530 % tp == 0, 2 % tp == 0
    assert plain[0] == [530 // tp if split_v else 530, 64]
    assert plain[4] == [2, 128 // tp, 64] and plain[5] == [2, 64, 128 // tp]
    assert plain[7] == [2, 64, 32 // tp if split_attn else 32] and plain[9] == [2, 64, 64 // tp if split_attn else 64]
    if dp > 1:
        assert got["zero1"]["local"] == plain
        assert got["fsdp"]["local"][4] == [1, 128 // tp, 64]  # FSDP: the layers split over dp too
    if mesh_shape == (1, 2):
        ops = got["ops"]
        assert ops["reduce_fwd"] == [10.0, 12.0, 14.0] and ops["reduce_bwd"] == [1.0, 2.0, 3.0]
        assert ops["copy_fwd"] == [0.0, 1.0, 2.0] and ops["copy_bwd"] == [3.0, 6.0, 9.0]
        loss, whole = ops["ce_loss"]
        assert loss == pytest.approx(whole, rel=1e-6)
        assert ops["ce_dh"] <= 1e-5 and ops["ce_de"] <= 1e-5 * max(1.0, ops["ce_scale"])


def test_vocab_slices_merge_to_the_whole_vocabulary_loss():
    """The slice path in one process (``merge_slices`` on the stacked slice
    lse, as ``chip_smoke.py`` phase p1 runs it): 3 slices of 7 rows; labels
    in each slice and ignored. The merged lse, the loss, dh summed over the
    slices and dE stacked equal the whole-vocabulary plain CE's; a merge that
    drops a slice and labels not remapped both miss."""
    from ssi_tpu_torch.ops import cross_entropy as ce
    from ssi_tpu_torch.ops.cross_entropy_cuda import merge_slices

    g = torch.Generator().manual_seed(3)
    n, d, rows, t = 33, 8, 7, 3
    h = torch.randn(n, d, generator=g, dtype=torch.float64).float()
    e = torch.randn(rows * t, d, generator=g, dtype=torch.float64).float()
    y = torch.randint(0, rows * t, (n,), generator=g)
    y[::4] = -100
    y[1:4] = torch.tensor([0, rows, 2 * rows - 1])
    one = torch.tensor(1.0)
    slices = [e[r * rows:(r + 1) * rows] for r in range(t)]
    parts = torch.stack([ce.cross_entropy_lse(h, s, 8) for s in slices])
    valid = y != -100

    def slice_path(parts, remap=True):
        lse, picked, dh, de = None, 0.0, 0.0, []
        for r, s in enumerate(slices):
            lse, local = merge_slices(parts, y, r * rows, rows)
            local = local if remap else y
            picked = picked + ce.slice_picked(h, s, local.clamp(-1, rows - 1) if not remap else local)
            dh = dh + ce.cross_entropy_dh(h, s, local, one, 8, lse=lse)
            de.append(ce.cross_entropy_de(h, s, local, one, 8, lse=lse))
        return lse, torch.where(valid, lse - picked, 0.0).sum(), dh, torch.cat(de)

    lse, loss, dh, de = slice_path(parts)
    torch.testing.assert_close(lse, ce.cross_entropy_lse(h, e, 8), rtol=1e-6, atol=1e-6)
    assert float(loss) == pytest.approx(float(ce.fused_cross_entropy(h, e, y, 8)), rel=1e-6)
    torch.testing.assert_close(dh, ce.cross_entropy_dh(h, e, y, one, 8), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(de, ce.cross_entropy_de(h, e, y, one, 8), rtol=1e-5, atol=1e-6)
    # the controls: one slice's lse dropped, and labels not remapped to their slice
    _, loss_c, _, _ = slice_path(parts[:-1])
    assert abs(float(loss_c) - float(loss)) > 1e-3 * abs(float(loss))
    _, _, dh_c, de_c = slice_path(parts, remap=False)
    assert (de_c - de).abs().max() > 1e-2 and (dh_c - dh).abs().max() > 1e-2


def test_slice_labels_remap():
    from ssi_tpu_torch.ops.cross_entropy import slice_labels

    y = torch.tensor([0, 4, 5, 9, 10, -100], dtype=torch.int32)
    assert slice_labels(y, 5, 5).tolist() == [-1, -1, 0, 4, -1, -100]
    assert slice_labels(y, 0, 5).tolist() == [0, 4, -1, -1, -1, -100]
    assert slice_labels(y, 5, 5).dtype == torch.int32


def test_the_tp_path_in_a_world_of_one_is_the_whole_path(monkeypatch):
    """A world-1 gloo group: its mesh carries the world group as its tp
    group and the training layout takes the tp path, but every tp
    collective is the identity and issues no call (a call raises here). The
    vocab-parallel loss over its one slice gives the whole-vocabulary plain
    loss's bits: the loss, dh and dE."""
    import torch.distributed as dist

    from ssi_tpu_torch.models.configs import get_model_config
    from ssi_tpu_torch.ops.cross_entropy import fused_cross_entropy
    from ssi_tpu_torch.ops.cross_entropy_cuda import vocab_parallel_cross_entropy
    from ssi_tpu_torch.parallel import StateLayout, copy_to_tp, make_mesh, reduce_from_tp, tp_all_gather, tp_all_reduce

    cfg = get_model_config("tiny_test")
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}", world_size=1, rank=0)
    try:
        mesh = make_mesh(dp=1, tp=1)
        assert mesh.tp_group is not None
        shapes = {"embed": (30, 16), "final_norm": (16,),
                  "layers": {k: (2, 16, 16) for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")}
                  | {"attn_norm": (2, 16), "mlp_norm": (2, 16)}}
        tp = StateLayout.build(mesh, shapes, zero1=False, fsdp=False, num_kv_heads=cfg.num_kv_heads).tensor_parallel()
        assert tp is not None and tp.embed and tp.head and tp.attn and tp.mlp

        def refused(*args, **kwargs):
            raise AssertionError("a tp collective ran at tp 1")

        for name in ("all_reduce", "all_gather_into_tensor", "all_gather"):
            monkeypatch.setattr(dist, name, refused)
        x = torch.arange(6.0).view(2, 3)
        assert tp_all_reduce(x, mesh) is x and tp_all_gather(x, -1, mesh) is x
        assert copy_to_tp(x, mesh) is x and reduce_from_tp(x, mesh) is x and tp.enter(x) is x and tp.reduce(x) is x
        g = torch.Generator().manual_seed(7)
        h = torch.randn(40, 16, generator=g)
        e = torch.randn(30, 16, generator=g) * 0.5
        lab = torch.randint(0, 30, (40,), generator=g)
        lab[::5] = -100
        got, want = [], []
        for fn, out in ((lambda a, b: vocab_parallel_cross_entropy(tp.enter(a), b, lab, mesh, 16), got),
                        (lambda a, b: fused_cross_entropy(a, b, lab, 16), want)):
            a, b = h.clone().requires_grad_(), e.clone().requires_grad_()
            loss = fn(a, b)
            out += [loss.detach(), *torch.autograd.grad(loss, (a, b))]
        assert all(torch.equal(p, q) for p, q in zip(got, want))
    finally:
        monkeypatch.undo()
        dist.destroy_process_group()


# --- the SFT CLI across dp x tp ranks ------------------------------------------------------------


def jax_run(assets, monkeypatch, out: str, dp: int, tp: int, batch: int):
    """The JAX Trainer on ``conf/sft.yaml`` with the CLI's overrides, one
    process, a ``(dp, tp)`` mesh of the virtual devices."""
    import datasets as hfd

    rows = assets[3]
    monkeypatch.setattr(jdata, "load_hf_dataset", lambda source, **kw: hfd.Dataset.from_list(rows))
    cfg = jax_compose(str(REPO / "conf"), "sft", overrides=[*sft_args(assets, out, batch), f"parallel.dp={dp}",
                                                              f"parallel.tp={tp}"])
    t = JaxTrainer(cfg)
    t.setup()
    losses: list[float] = []
    t._loss_log = losses
    t.train()
    t.cleanup()
    return t, losses


@pytest.fixture(scope="module")
def cli_runs(assets):
    return {
        "tp2": run_ranks(assets, "tp2", "parallel.tp=2", "sharded_optimizer_state=true", batch=4, keep=2),
        "tp2_again": run_ranks(assets, "tp2_again", "parallel.tp=2", "sharded_optimizer_state=true", batch=4),
        "dp2": run_ranks(assets, "dp2_tp1", "parallel.tp=1", "sharded_optimizer_state=true", keep=2),
        "dp2tp2": run_ranks(assets, "dp2tp2", "parallel.tp=2", "parallel.zero1=true", n=4, keep=2, check_groups=True),
    }


def assert_one_stream(ranks: list[dict]) -> None:
    for r in ranks[1:]:
        assert r["losses"] == ranks[0]["losses"]
        assert strip_timing(r["history"]) == strip_timing(ranks[0]["history"])


@pytest.mark.parametrize("name,dp,tp", [("tp2", 1, 2), ("dp2tp2", 2, 2)])
def test_sft_cli_matches_the_jax_trainer_on_its_mesh(assets, cli_runs, monkeypatch, name, dp, tp):
    root = assets[0]
    ranks = cli_runs[name]
    assert_one_stream(ranks)
    assert len(ranks[0]["losses"]) == 4 and ranks[0]["world_size"] == dp * tp
    assert ranks[0]["consumed_samples"] == 4 * 2 * 4  # steps x accumulation x global batch
    # the tp ranks of a dp column read the same rows, the columns disjoint ones
    shards = [r["shard"] for r in ranks]
    for r in range(dp * tp):
        assert shards[r] == shards[(r // tp) * tp]
    if dp > 1:
        assert set(shards[0]).isdisjoint(shards[tp])
    t, losses = jax_run(assets, monkeypatch, f"jax_{name}", dp, tp, 4)
    assert len(losses) == 4
    for got, want in zip(ranks[0]["losses"], losses):
        assert got == pytest.approx(want, rel=1e-5), (ranks[0]["losses"], losses)
    dev = [r["dev_loss"] for r in ranks[0]["history"] if "dev_loss" in r]
    j_dev = [r["dev_loss"] for r in t.metric_logger.history if "dev_loss" in r]
    assert len(dev) == len(j_dev) == 2
    np.testing.assert_allclose(dev, j_dev, rtol=1e-5)
    p_w, j_w = weights(root, name), weights(root, f"jax_{name}")
    assert list(p_w) == list(j_w)
    for k in j_w:
        assert (p_w[k] - j_w[k]).norm() <= 2e-5 * j_w[k].norm(), k
    if name == "dp2tp2":
        # every collective of the port's step, model and checkpoint code named its group
        for r in ranks:
            calls = r["grouped"]
            assert any(k.startswith("ssi_tpu_torch.train.step.") for k in calls), calls
            assert any(k.startswith("ssi_tpu_torch.parallel.") and "gather" in k for k in calls), calls
            # ZeRO-1 at dp 2: the moments are half of every leaf the rule shards
            assert sum(r["moment_numel"]) < sum(r["param_numel"])


def test_two_tp_runs_are_bitwise_and_step_n_is_a_whole_save(assets, cli_runs, tmp_path):
    from ssi_tpu_torch.checkpoint import Checkpointer
    from ssi_tpu_torch.models.configs import get_model_config

    root = assets[0]
    a, b = cli_runs["tp2"], cli_runs["tp2_again"]
    assert a[0]["losses"] == b[0]["losses"]
    assert strip_timing(a[0]["history"]) == strip_timing(b[0]["history"])
    name = "ft-model-00001-of-00001.safetensors"
    saved = (root / "tp2" / "step_4" / name).read_bytes()
    assert saved == (root / "tp2_again" / "step_4" / name).read_bytes()
    # step_4/ holds the whole weights: a one-process save of them writes the same bytes
    cfg = get_model_config("tiny_test")
    cfg.n_dsus, cfg.modality_tokens = helpers.TINY_N_DSUS, helpers.TINY_USE_MODALITY
    ckpt = Checkpointer(root / "tp2" / "step_4", output_dir=tmp_path)
    params = ckpt.load_params(cfg, torch.float32, "cpu")
    assert params["embed"].shape == (530, 64)
    step_dir = ckpt.save_model_checkpoint(params, cfg, 4)
    assert (step_dir / name).read_bytes() == saved


@pytest.mark.parametrize("src,dst", [("dp2", "tp2"), ("tp2", "dp2")])
def test_sharded_state_resumes_across_dp_and_tp(assets, cli_runs, src, dst):
    """A DCP state saved at one layout resumes at the other (the same global
    batch: 2 rows a column at dp 2, 4 at dp 1; ``force_resume`` across the
    replica count) and continues the saving run's loss stream."""
    root = assets[0]
    out = {"dp2": "dp2_tp1", "tp2": "tp2"}
    layout = {"dp2": ("parallel.tp=1",), "tp2": ("parallel.tp=2",)}
    batch = {"dp2": 2, "tp2": 4}
    full = cli_runs[src][0]["losses"]
    resumed = run_ranks(assets, f"{src}_to_{dst}", *layout[dst], "sharded_optimizer_state=true", "force_resume=true",
                        *resume_args(root / out[src]), batch=batch[dst])
    assert_one_stream(resumed)
    assert len(resumed[0]["losses"]) == 2
    np.testing.assert_allclose(resumed[0]["losses"], full[2:], rtol=1e-5)
    # the two layouts train alike at the same global batch
    np.testing.assert_allclose(cli_runs["dp2"][0]["losses"], cli_runs["tp2"][0]["losses"], rtol=1e-5)


def test_msgpack_state_of_dp2tp2_resumes_at_tp2(assets, cli_runs):
    """The msgpack route: dp2 x tp2 ZeRO-1 writes whole moments at step 2
    (gathered over dp, then tp), and a dp1 x tp2 run (4 rows a column)
    resumed from them continues dp2 x tp2's loss stream."""
    from ssi_tpu_torch.checkpoint import msgpack_io, sharded_io

    root = assets[0]
    state = msgpack_io.load(root / "dp2tp2" / "kept2" / "training_state.msgpack")
    assert not sharded_io.is_marker(state["optimizer"]) and int(state["optimizer"]["count"]) == 2
    assert np.asarray(state["optimizer"]["mu"]["embed"]).shape == (530, 64)
    resumed = run_ranks(assets, "dp2tp2_to_tp2", "parallel.tp=2", "force_resume=true", *resume_args(root / "dp2tp2"),
                        batch=4)
    assert_one_stream(resumed)
    np.testing.assert_allclose(resumed[0]["losses"], cli_runs["dp2tp2"][0]["losses"][2:], rtol=1e-5)

