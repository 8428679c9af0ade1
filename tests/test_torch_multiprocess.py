"""Data parallelism in the port across real processes: 2 gloo ranks on the
CPU, each a process running the port's SFT CLI (``ssi_tpu_torch.cli.train_sft``
``main``, ``conf/sft.yaml`` as it stands, ``+device=cpu``,
``parallel.distributed=true`` with an explicit coordinator on a free localhost
port), in the style of ``tests/test_multiprocess.py``; the port's counterpart
of the JAX package's multi-device dry run.

Held:

- plain DP: one loss stream on both ranks, bitwise; disjoint data shards
  covering the split; the losses and dev losses within ``rel=1e-5`` of the
  JAX package's one-process ``parallel.dp=2`` run at twice the batch (the
  JAX Trainer on ``conf/sft.yaml`` with the same overrides; the tolerance
  ``tests/test_multiprocess.py`` holds the JAX pair to), the ``step_4/``
  weights within the trainer tests' 2e-5, in relative norm per tensor (a
  weight whose gradient is near zero moves by Adam's normalised step, so a
  sum of the batch in another order moves single elements by more);
  ``overlap_io`` on and off log equal values;
- ZeRO-1 equal to plain DP bitwise (a two-rank reduce-scatter adds the same
  two numbers as the all-reduce), its ``grad_norm`` within 1e-6 (each leaf's
  squares are summed over its slices, then added); FSDP's losses, norms and
  weights (in norm) within 1e-5 of plain DP's (a micro-batch's gradient is
  reduce-scattered in the backward, so the window sums the ranks before the
  micro-batches); each rank's moments, and under FSDP its parameters, are
  1/dp of every leaf the layout rule shards;
- the sharded optimizer state: an FSDP run saves at step 2 and 4; a dp=2
  resume from step 2 runs steps 3-4 and writes moments bitwise equal to the
  uninterrupted run's, and a dp=1 resume of the dp=2 save (``force_resume``
  across the world size) reads moments bitwise equal to the saved state;
- the msgpack route under ZeRO-1 gathers the same optimizer state as plain DP.

The runs clip at 1e9, above every norm, so a norm that differs in its last
bits changes no update (the norms themselves are compared).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import ssi_tpu.data as jdata
from ssi_tpu.config import compose as jax_compose
from ssi_tpu.train import Trainer as JaxTrainer
from ssi_tpu_torch.checkpoint import msgpack_io
from ssi_tpu_torch.checkpoint.safetensors_io import load_file
from ssi_tpu_torch.parallel import StateLayout, make_mesh
from tests import helpers

REPO = Path(__file__).resolve().parent.parent
STEPS = 4
PER_RANK_BATCH = 2
N_ROWS = 32  # 4 windows of 2 micro-batches x 2 rows x 2 ranks: one epoch
TIMING = {"duration_step", "tokens_per_second_per_gpu", "train_clock_time"}

# One rank: the SFT CLI's ``main`` on argv[2:], its readings to argv[1].
# ``KEEP`` (an environment variable) names a step whose state file and sharded
# optimizer directory are hard-linked into <output_dir>/kept<step>/ (later
# saves replace and prune them), so a later run can resume from it.
# ``CHECK_GROUPS=1`` refuses a collective that the port's code calls on the
# world group (``group`` None or WORLD) and counts the others.
_WORKER = """
import json, os, sys
from pathlib import Path
import torch
import torch.distributed as dist
from ssi_tpu_torch.checkpoint import Checkpointer, sharded_io
from ssi_tpu_torch.cli.train_sft import main
from ssi_tpu_torch.train.optimizer import tree_leaves

grouped = {}
if os.environ.get("CHECK_GROUPS") == "1":
    def checked(name, fn):
        def call(*args, group=None, **kwargs):
            caller = sys._getframe(1).f_globals.get("__name__", "")
            if caller.startswith("ssi_tpu_torch."):
                if group is None or group is dist.group.WORLD:
                    raise AssertionError(f"{caller} called {name} on the world group")
                grouped[f"{caller}.{name}"] = grouped.get(f"{caller}.{name}", 0) + 1
            return fn(*args, group=group, **kwargs)
        return call
    for name in ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor", "broadcast", "reduce",
                 "all_gather"):
        setattr(dist, name, checked(name, getattr(dist, name)))

keep = int(os.environ.get("KEEP", "0"))
original = Checkpointer.save_training_state

def save_and_keep(ckpt, **kwargs):
    path = original(ckpt, **kwargs)
    if kwargs["global_step"] == keep:
        out = ckpt.output_dir
        kept = out / f"kept{keep}"
        kept.mkdir()
        os.link(path, kept / path.name)
        marker = kwargs["optimizer_state"].get(sharded_io.DCP_DIR_KEY)
        for f in (out / marker).rglob("*") if marker else ():
            (kept / f.relative_to(out)).parent.mkdir(parents=True, exist_ok=True)
            os.link(f, kept / f.relative_to(out))
    return path

Checkpointer.save_training_state = save_and_keep
torch.set_num_threads(2)
t = main(sys.argv[2:])
state = t.state
record = {
    "rank": t.rank, "world_size": t.world_size, "history": t.metric_logger.history,
    "losses": [r["loss"] for r in t.metric_logger.history if "loss" in r],
    "shard": list(iter(t.sampler_train)), "consumed_samples": t.consumed_samples,
    "param_numel": [p.numel() for p in tree_leaves(state["params"])],
    "moment_numel": [m.numel() for m in tree_leaves(state["opt_state"]["mu"])],
    "grouped": grouped,
}
Path(sys.argv[1]).write_text(json.dumps(record))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def sft_args(assets, out: str, batch: int = PER_RANK_BATCH, *extra) -> list[str]:
    """The SFT CLI's overrides (``conf/sft.yaml``) for the tiny checkpoint
    and split: 4 steps of 2 micro-batches, a save and a dev loss every 2,
    and the f32 accumulation and moments of the trainer tests' config (the
    conf's bf16 moments would round a sum taken in another order
    otherwise, and the weights could not be held to f32's tolerance)."""
    root, model_dir, split, _ = assets
    args = ["data=sft/mls-hubert_large_ll60k-layer_22", "model_config=tiny_test", f"speech.n_dsus={helpers.TINY_N_DSUS}",
            f"checkpointer.checkpoint_dir={model_dir}", f"tokenizer.path={model_dir}/original/tokenizer.model",
            "tokenizer.max_seq_len=384", f"max_steps={STEPS}", "save_steps=2", "eval_steps=2", "log_interval=1",
            "gradient_accumulation_steps=2", "lr_scheduler=null", "clip_grad_norm=1e9", "dtype=fp32",
            "grad_accum_dtype=fp32", "optimizer.mu_dtype=fp32", "optimizer.nu_dtype=fp32",
            "wandb.enabled=false", "hydra/job_logging=none", f"checkpointer.output_dir={root / out}"]
    for name in ("train", "dev"):
        args += [f"data.{name}.dataset.source=json", f"data.{name}.dataset.split=train",
                 f"+data.{name}.dataset.data_files={split}", f"data.{name}.dataloader.batch_size={batch}"]
    return args + list(extra)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("mp_torch")
    model_dir = helpers.make_tiny_hf_checkpoint(root / "model")
    rows = helpers.synthetic_sft_rows(N_ROWS)
    split = root / "sft.jsonl"
    split.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return root, model_dir, split, rows


def run_ranks(assets, out: str, *extra, n: int = 2, keep: int = 0, batch: int = PER_RANK_BATCH,
              check_groups: bool = False) -> list[dict]:
    """``n`` port ranks, each a process running the SFT CLI with ``extra``
    overrides and ``batch`` rows a dp column. Returns each rank's readings."""
    root = assets[0]
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "SSI_TPU_COMPILE_CACHE"}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="2", KEEP=str(keep), CHECK_GROUPS=str(int(check_groups)))
    procs = []
    for r in range(n):
        args = sft_args(assets, out, batch, *extra, "+device=cpu", "parallel.distributed=true",
                        f"+parallel.coordinator_address=localhost:{port}", f"+parallel.num_processes={n}",
                        f"+parallel.process_id={r}")
        procs.append(subprocess.Popen([sys.executable, "-c", _WORKER, str(root / f"{out}_rank{r}.json"), *args],
                                      cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{o[-4000:]}"
    return [json.loads((root / f"{out}_rank{r}.json").read_text()) for r in range(n)]


def resume_args(src: str) -> list[str]:
    return [f"checkpointer.checkpoint_dir={src}/step_2", f"checkpointer.training_state_checkpoint={src}/kept2/"
            "training_state.msgpack"]


def strip_timing(history):
    return [{k: v for k, v in rec.items() if k not in TIMING} for rec in history]


def weights(root: Path, out: str, step: int = STEPS) -> dict[str, torch.Tensor]:
    return load_file(next((root / out / f"step_{step}").glob("*.safetensors")))


def read_dcp(path: Path, like: dict) -> dict:
    """A sharded optimizer directory read whole, with no process group
    (``like``: an optimizer tree of the whole shapes and dtypes)."""
    import torch.distributed.checkpoint as dcp

    from ssi_tpu_torch.train.optimizer import tree_map

    sd = {m: tree_map(lambda x: torch.empty_like(torch.as_tensor(x)), like[m]) for m in ("mu", "nu")}
    sd["count"] = torch.tensor(0, dtype=torch.int32)
    dcp.load(sd, checkpoint_id=str(path), no_dist=True)
    return sd


def assert_trees_equal(a: dict, b: dict) -> None:
    from ssi_tpu_torch.train.optimizer import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(map(torch.as_tensor, la), map(torch.as_tensor, lb)):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.fixture(scope="module")
def runs(assets):
    return {
        "plain": run_ranks(assets, "plain"),
        "zero1": run_ranks(assets, "zero1", "parallel.zero1=true"),
        "fsdp": run_ranks(assets, "fsdp", "parallel.fsdp=true", "sharded_optimizer_state=true", keep=2),
    }


def test_plain_dp_matches_the_jax_dp2_run(assets, runs, monkeypatch):
    root, _, _, rows = assets
    r0, r1 = runs["plain"]
    assert len(r0["losses"]) == STEPS and r0["world_size"] == 2
    assert r0["losses"] == r1["losses"]  # one loss stream, bitwise
    assert strip_timing(r0["history"]) == strip_timing(r1["history"])
    assert r0["consumed_samples"] == r1["consumed_samples"] == STEPS * 2 * PER_RANK_BATCH * 2
    s0, s1 = set(r0["shard"]), set(r1["shard"])
    assert s0.isdisjoint(s1) and len(r0["shard"]) == len(r1["shard"]) and s0 | s1 == set(range(N_ROWS))

    # the JAX Trainer on conf/sft.yaml with the same overrides, one process, dp=2 at twice the batch
    import datasets as hfd

    monkeypatch.setattr(jdata, "load_hf_dataset", lambda source, **kw: hfd.Dataset.from_list(rows))
    cfg = jax_compose(str(REPO / "conf"), "sft", overrides=[*sft_args(assets, "jax_dp2", 2 * PER_RANK_BATCH),
                                                              "parallel.dp=2"])
    t = JaxTrainer(cfg)
    t.setup()
    losses: list[float] = []
    t._loss_log = losses
    t.train()
    t.cleanup()
    assert len(losses) == STEPS
    for got, want in zip(r0["losses"], losses):
        assert got == pytest.approx(want, rel=1e-5), (r0["losses"], losses)
    dev = [r["dev_loss"] for r in r0["history"] if "dev_loss" in r]
    j_dev = [r["dev_loss"] for r in t.metric_logger.history if "dev_loss" in r]
    assert len(dev) == len(j_dev) == 2
    np.testing.assert_allclose(dev, j_dev, rtol=1e-5)
    assert t.consumed_samples == r0["consumed_samples"]
    p_w, j_w = weights(root, "plain"), weights(root, "jax_dp2")
    assert list(p_w) == list(j_w)
    for k in j_w:  # in norm: Adam moves a weight whose gradient is ~0 by its normalised step
        assert (p_w[k] - j_w[k]).norm() <= 2e-5 * j_w[k].norm(), k
    # rank-0-writes: one metrics file, the final save
    assert len((root / "plain" / "metrics.jsonl").read_text().splitlines()) == len(r0["history"])


def test_overlap_io_on_and_off_log_equal_values(assets, runs):
    root = assets[0]
    sync = run_ranks(assets, "plain_sync", "overlap_io=false")
    assert sync[0]["losses"] == sync[1]["losses"] == runs["plain"][0]["losses"]
    assert strip_timing(sync[0]["history"]) == strip_timing(runs["plain"][0]["history"])
    assert (root / "plain_sync" / "step_4" / "ft-model-00001-of-00001.safetensors").read_bytes() == \
        (root / "plain" / "step_4" / "ft-model-00001-of-00001.safetensors").read_bytes()


def _layout(assets, **flags) -> StateLayout:
    from ssi_tpu_torch.checkpoint import Checkpointer
    from ssi_tpu_torch.models.configs import get_model_config
    from ssi_tpu_torch.train.optimizer import tree_map

    root, model_dir, _, _ = assets
    cfg = get_model_config("tiny_test")
    cfg.n_dsus, cfg.modality_tokens = helpers.TINY_N_DSUS, helpers.TINY_USE_MODALITY
    params = Checkpointer(model_dir, output_dir=root / "unused").load_params(cfg, torch.float32, "cpu")
    return StateLayout.build(make_mesh(dp=2, world_size=2), tree_map(lambda t: tuple(t.shape), params),
                             num_kv_heads=cfg.num_kv_heads, **flags)


@pytest.mark.parametrize("mode", ["zero1", "fsdp"])
def test_zero1_and_fsdp_equal_plain_dp_and_shard_by_the_rule(assets, runs, mode):
    from ssi_tpu_torch.train.optimizer import tree_leaves

    root = assets[0]
    plain, run = runs["plain"], runs[mode]
    assert run[0]["losses"] == run[1]["losses"]
    norms = [[r["grad_norm"] for r in ranks[0]["history"] if "grad_norm" in r] for ranks in (plain, run)]
    assert len(norms[0]) == STEPS
    p_w, w = weights(root, "plain"), weights(root, mode)
    if mode == "zero1":
        np.testing.assert_allclose(norms[1], norms[0], rtol=1e-6)
        assert run[0]["losses"] == plain[0]["losses"]
        assert all(torch.equal(w[k], p_w[k]) for k in p_w)
    else:
        np.testing.assert_allclose(norms[1], norms[0], rtol=1e-5)
        np.testing.assert_allclose(run[0]["losses"], plain[0]["losses"], rtol=1e-5)
        for k in p_w:
            assert (w[k] - p_w[k]).norm() <= 1e-5 * p_w[k].norm(), k
    layout = _layout(assets, zero1=True, fsdp=mode == "fsdp")
    full = [int(np.prod(s)) for s in tree_leaves(layout.shapes)]
    assert any(d is not None for d in tree_leaves(layout.moments))
    for r in run:
        want_m = [n // 2 if d is not None else n for n, d in zip(full, tree_leaves(layout.moments))]
        want_p = [n // 2 if d is not None else n for n, d in zip(full, tree_leaves(layout.params))]
        assert r["moment_numel"] == want_m
        assert r["param_numel"] == (want_p if mode == "fsdp" else full)
    for r in plain:
        assert r["moment_numel"] == r["param_numel"] == full


def test_msgpack_route_under_zero1_writes_plain_dps_state(assets, runs):
    root = assets[0]
    p = msgpack_io.load(root / "plain" / "training_state.msgpack")
    z = msgpack_io.load(root / "zero1" / "training_state.msgpack")
    assert list(z) == list(p)
    volatile = ("timestamp", "cumulative_metrics", "rng_state", "optimizer")
    assert {k: v for k, v in z.items() if k not in volatile} == {k: v for k, v in p.items() if k not in volatile}
    assert {k: v for k, v in z["cumulative_metrics"].items() if k != "wall_clock_seconds"} == \
        {k: v for k, v in p["cumulative_metrics"].items() if k != "wall_clock_seconds"}
    assert int(z["optimizer"]["count"]) == int(p["optimizer"]["count"]) == STEPS
    assert_trees_equal({m: z["optimizer"][m] for m in ("mu", "nu")}, {m: p["optimizer"][m] for m in ("mu", "nu")})


def test_sharded_state_resumes_bitwise_at_dp2_and_reshards_to_dp1(assets, runs):
    from ssi_tpu_torch.checkpoint import sharded_io

    root = assets[0]
    full = runs["fsdp"]
    state = msgpack_io.load(root / "fsdp" / "training_state.msgpack")
    assert sharded_io.is_marker(state["optimizer"])
    assert sorted(p.name for p in (root / "fsdp").glob("optimizer_state_dcp_step*")) == ["optimizer_state_dcp_step4"]
    like = msgpack_io.load(root / "plain" / "training_state.msgpack")["optimizer"]

    # dp=2 resume from step 2: steps 3-4 and the step-4 moments equal the uninterrupted run's
    resumed = run_ranks(assets, "fsdp_resumed", "parallel.fsdp=true", "sharded_optimizer_state=true",
                        *resume_args(root / "fsdp"))
    assert resumed[0]["losses"] == resumed[1]["losses"] == full[0]["losses"][2:]
    assert (root / "fsdp_resumed" / "step_4" / "ft-model-00001-of-00001.safetensors").read_bytes() == \
        (root / "fsdp" / "step_4" / "ft-model-00001-of-00001.safetensors").read_bytes()
    a = read_dcp(root / "fsdp" / "optimizer_state_dcp_step4", like)
    b = read_dcp(root / "fsdp_resumed" / "optimizer_state_dcp_step4", like)
    assert int(a["count"]) == int(b["count"]) == STEPS
    assert_trees_equal(a, b)

    # dp=1, one process, no process group: the CLI's config, a Trainer set up on
    # the dp=2 step-2 save reads it re-sharded to whole moments
    from ssi_tpu_torch.config import compose
    from ssi_tpu_torch.train.train_utils import resolve_n_dsus
    from ssi_tpu_torch.train.trainer import Trainer

    saved = read_dcp(root / "fsdp" / "kept2" / "optimizer_state_dcp_step2", like)
    cfg = compose(str(REPO / "conf"), "sft", overrides=sft_args(
        assets, "dp1_from_dp2", PER_RANK_BATCH, "sharded_optimizer_state=true", "force_resume=true", "+device=cpu",
        *resume_args(root / "fsdp")))
    resolve_n_dsus(cfg)
    t = Trainer(cfg)
    t.setup()
    assert not t.distributed and t.world_size == 1 and t.global_step == 2
    assert t.state["opt_state"]["count"] == int(saved["count"]) == 2
    assert_trees_equal({m: t.state["opt_state"][m] for m in ("mu", "nu")}, {m: saved[m] for m in ("mu", "nu")})
    t.cleanup()
