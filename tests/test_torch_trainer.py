"""The port's ``Trainer`` (``ssi_tpu_torch/train/trainer.py``) against the JAX
package's on the same tiny fp32 checkpoint (``tests/helpers.py``
``make_tiny_hf_checkpoint``) and SFT rows (the JAX side from the
``synthetic_data``-style patch, the port from a JSON-lines file), on the CPU
(``device: cpu``), and the port's copies of the JAX host modules it drives
(``train_utils``, ``setup_lr_schedule``, ``AdamWConfig.from_cfg``,
``setup_metric_logger``).

Held: per-step losses and dev losses within 2e-5 relative; token-type counts,
token totals and ``consumed_samples`` exactly; ``step_N/`` weights within
2e-5; the training state's keys; the port's own resume bitwise, within an
epoch and across an epoch boundary; a JAX-written state resumed by the port
and a port-written one by JAX, each within 2e-5 of the other package's
uninterrupted run; ``overlap_io`` on and off equal, and each logged
``duration_step`` holding its own window's time; retention with
``async_save``; the final checkpoint at ``max_steps``; the hparam guard; the
zero-token window; the ``profiler`` key; the refusals (no card, tensor
parallelism, dp beyond the world size, an Orbax state); ZeRO-1, FSDP and the
sharded optimizer state at one rank, equal to the plain run bitwise.
"""

import copy
import itertools
import json
from pathlib import Path
import types

import numpy as np
import pytest
import torch

import ssi_tpu.data as jdata
from ssi_tpu.checkpoint import unpack_state
from ssi_tpu.config import Config as JaxConfig
from ssi_tpu.train import Trainer as JaxTrainer
from ssi_tpu.train import lr_schedule as jsched
from ssi_tpu.train import optimizer as jopt
from ssi_tpu.train import train_utils as jutils
from ssi_tpu_torch.checkpoint import msgpack_io
from ssi_tpu_torch.checkpoint.safetensors_io import load_file
from ssi_tpu_torch.config import Config as PortConfig
from ssi_tpu_torch.train import lr_schedule as psched
from ssi_tpu_torch.train import optimizer as popt
from ssi_tpu_torch.train import train_utils as putils
from ssi_tpu_torch.train.metric_logging import JsonlLogger, setup_metric_logger
from ssi_tpu_torch.train import trainer as trainer_module
from ssi_tpu_torch.train.trainer import Trainer
from tests import helpers

N_ROWS = 24  # 12 batches of 2, 6 windows of 2 per epoch
TIMING = {"duration_step", "tokens_per_second_per_gpu", "train_clock_time"}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer")
    model_dir = helpers.make_tiny_hf_checkpoint(root / "model")
    rows = helpers.synthetic_sft_rows(N_ROWS)
    split = root / "sft.jsonl"
    split.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return root, model_dir, split, rows


@pytest.fixture(scope="module")
def jax_rows(assets):
    """The JAX trainer reads the same rows through a patched ``load_hf_dataset``."""
    import datasets as hfd

    mp = pytest.MonkeyPatch()
    rows = assets[3]
    mp.setattr(jdata, "load_hf_dataset", lambda source, **kw: hfd.Dataset.from_list(rows))
    yield
    mp.undo()


def _merge(dst: dict, src: dict) -> dict:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge(dst[k], v)
        else:
            dst[k] = v
    return dst


def cfg_dict(model_dir, out, split=None, **over) -> dict:
    """The tiny SFT config: the JAX package's (``split`` None) or the port's
    (JSON-lines ``split``, ``device: cpu``, ``attn_impl: auto``)."""
    d = helpers.base_train_cfg_dict(model_dir, out, kind="sft")
    d.update(max_steps=6, save_steps=3, eval_steps=3, remat="save_qkv_mlp", lr_scheduler=None)
    if split is not None:
        d.update(attn_impl="auto", device="cpu")
        for name in ("train", "dev"):
            d["data"][name]["dataset"].update(source="json", data_files=str(split), split="train")
    return _merge(d, copy.deepcopy(over))


def run(trainer_cls, cfg: dict):
    t = trainer_cls((PortConfig if trainer_cls is Trainer else JaxConfig)(cfg))
    t.setup()
    losses: list[float] = []
    t._loss_log = losses
    t.train()
    t.cleanup()
    return t, losses, list(t.metric_logger.history)


def port_run(assets, out, **over):
    root, model_dir, split, _ = assets
    return run(Trainer, cfg_dict(model_dir, root / out, split, **over))


def jax_run(assets, out, **over):
    root, model_dir, _, _ = assets
    return run(JaxTrainer, cfg_dict(model_dir, root / out, **over))


def assert_close(a, b, rtol=2e-5):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=rtol)


def strip_timing(history):
    return [{k: v for k, v in rec.items() if k not in TIMING} for rec in history]


def key_tree(x):
    return {k: key_tree(v) for k, v in x.items()} if isinstance(x, dict) else None


@pytest.fixture(scope="module")
def runs(assets, jax_rows):
    """Uninterrupted 6-step runs of both packages (cosine schedule, dev loss
    and saves at steps 3 and 6), and the first halves of the resume runs
    (constant lr, 4 steps, saves at 2 and 4) with their full 8-step twins."""
    cosine = {"lr_scheduler": {"num_warmup_steps": 2, "num_cycles": 0.5}}
    out = {"port": port_run(assets, "port6", **cosine), "jax": jax_run(assets, "jax6", **cosine)}
    halves = {"max_steps": 4, "save_steps": 2, "eval_steps": 2}
    fulls = {"max_steps": 8, "save_steps": 2, "eval_steps": 2}
    out["port_half"] = port_run(assets, "port_half", **halves)
    out["port_full"] = port_run(assets, "port_full", **fulls)
    out["jax_half"] = jax_run(assets, "jax_half", **halves)
    out["jax_full"] = jax_run(assets, "jax_full", **fulls)
    return out


def test_trainer_matches_jax(assets, runs):
    root = assets[0]
    (pt, p_losses, p_hist), (jt, j_losses, j_hist) = runs["port"], runs["jax"]
    assert len(p_losses) == len(j_losses) == 6
    assert_close(p_losses, j_losses)
    p_dev = [r["dev_loss"] for r in p_hist if "dev_loss" in r]
    j_dev = [r["dev_loss"] for r in j_hist if "dev_loss" in r]
    assert len(p_dev) == len(j_dev) == 2
    assert_close(p_dev, j_dev)
    for p, j in zip(p_hist, j_hist):
        assert {k: v for k, v in p.items() if k.startswith("n_tokens.") or k in ("step", "tokens_total",
                                                                                  "max_seq_len_step")} == \
            {k: v for k, v in j.items() if k.startswith("n_tokens.") or k in ("step", "tokens_total",
                                                                               "max_seq_len_step")}
        assert_close([p["lr"], p["grad_norm"]], [j["lr"], j["grad_norm"]])
    assert (pt.consumed_samples, pt.consumed_windows, pt.tokens_train_total, dict(pt.token_type_counts_total)) == \
        (jt.consumed_samples, jt.consumed_windows, jt.tokens_train_total, dict(jt.token_type_counts_total))
    for step in (3, 6):
        p_dir, j_dir = root / "port6" / f"step_{step}", root / "jax6" / f"step_{step}"
        assert sorted(p.name for p in p_dir.rglob("*")) == sorted(p.name for p in j_dir.rglob("*"))
        p_w, j_w = load_file(next(p_dir.glob("*.safetensors"))), load_file(next(j_dir.glob("*.safetensors")))
        assert list(p_w) == list(j_w)
        for k in j_w:
            assert p_w[k].dtype == j_w[k].dtype
            np.testing.assert_allclose(p_w[k].numpy(), j_w[k].numpy(), rtol=2e-5, atol=2e-5 * j_w[k].abs().max().item())
        assert json.loads((p_dir / "model.safetensors.index.json").read_text()) == \
            json.loads((j_dir / "model.safetensors.index.json").read_text())
    p_state = msgpack_io.load(root / "port6" / "training_state.msgpack")
    j_state = unpack_state((root / "jax6" / "training_state.msgpack").read_bytes())
    assert key_tree(p_state) == key_tree(j_state)
    assert json.dumps(key_tree(p_state)) == json.dumps(key_tree(j_state))  # the same order
    assert {k: v for k, v in p_state.items() if k not in ("optimizer", "rng_state", "timestamp", "cumulative_metrics")} \
        == {k: v for k, v in j_state.items() if k not in ("optimizer", "rng_state", "timestamp", "cumulative_metrics")}


def resume(trainer_cls, assets, out, src: Path, max_steps: int = 8, **over):
    """A fresh trainer of ``trainer_cls`` from ``src/step_4`` and its training state."""
    root, _, split, _ = assets
    cfg = cfg_dict(src / "step_4", root / out, split if trainer_cls is Trainer else None,
                   max_steps=max_steps, save_steps=2, eval_steps=2, **over)
    cfg["checkpointer"]["training_state_checkpoint"] = str(src / "training_state.msgpack")
    return run(trainer_cls, cfg)


def test_port_resume_is_bitwise_across_an_epoch_boundary(assets, runs):
    """4 steps, then a fresh Trainer from step_4/ and the state: steps 5-8
    (the epoch ends after step 6) equal the uninterrupted run's, loss for loss
    and metric for metric, and so do the final weights."""
    root = assets[0]
    _, half, half_hist = runs["port_half"]
    _, full, full_hist = runs["port_full"]
    t, rest, rest_hist = resume(Trainer, assets, "port_resumed", root / "port_half")
    assert t.global_step == 8 and half + rest == full
    merged = {r["step"]: r for r in strip_timing(half_hist + rest_hist)}
    assert [merged[r["step"]] for r in strip_timing(full_hist)] == strip_timing(full_hist)
    assert (root / "port_resumed" / "step_8" / "ft-model-00001-of-00001.safetensors").read_bytes() == \
        (root / "port_full" / "step_8" / "ft-model-00001-of-00001.safetensors").read_bytes()


def test_jax_state_resumed_by_the_port(assets, runs):
    root = assets[0]
    _, jax_full, _ = runs["jax_full"]
    t, rest, _ = resume(Trainer, assets, "port_from_jax", root / "jax_half")
    assert t.global_step == 8 and len(rest) == 4
    assert_close(rest, jax_full[4:])


def test_port_state_resumed_by_jax(assets, runs):
    root = assets[0]
    _, port_full, _ = runs["port_full"]
    t, rest, _ = resume(JaxTrainer, assets, "jax_from_port", root / "port_half")
    assert t.global_step == 8 and len(rest) == 4
    assert_close(rest, port_full[4:])


def test_overlap_io_equals_the_synchronous_loop(assets, runs):
    _, losses, hist = runs["port_full"]
    _, sync_losses, sync_hist = port_run(assets, "port_sync", max_steps=8, save_steps=2, eval_steps=2,
                                         overlap_io=False)
    root = assets[0]
    assert sync_losses == losses and strip_timing(sync_hist) == strip_timing(hist)
    for step in (2, 8):
        assert (root / "port_sync" / f"step_{step}" / "ft-model-00001-of-00001.safetensors").read_bytes() == \
            (root / "port_full" / f"step_{step}" / "ft-model-00001-of-00001.safetensors").read_bytes()


@pytest.mark.parametrize("overlap", [True, False])
def test_each_duration_step_times_its_own_window(assets, monkeypatch, overlap):
    """On a clock that only the work below advances, window k's step takes
    k + 1 seconds and each dev loss and save 100: every logged
    ``duration_step`` is its own window's step, exactly, with ``overlap_io``
    (one window in flight; the loop drains before each save and dev loss)
    and without it, and no duration holds a neighbour's step, save or dev
    loss."""
    root, model_dir, split, _ = assets
    clock = [0.0]
    monkeypatch.setattr(trainer_module, "time", types.SimpleNamespace(perf_counter=lambda: clock[0]))
    t = Trainer(PortConfig(cfg_dict(model_dir, root / f"port_timing_{overlap}", split, max_steps=6,
                                    save_steps=3, eval_steps=3, overlap_io=overlap)))
    t.setup()
    step, calls, evaluate, save = t.train_step, itertools.count(1), t._evaluate, t.save_checkpoint

    def costs(seconds, fn):
        def run(*args):
            clock[0] += seconds() if callable(seconds) else seconds
            return fn(*args)
        return run

    t.train_step = costs(lambda: float(next(calls)), step)
    t._evaluate, t.save_checkpoint = costs(100.0, evaluate), costs(100.0, save)
    t.train()
    t.cleanup()
    assert [r["duration_step"] for r in t.metric_logger.history if "duration_step" in r] == [1.0, 2.0, 3.0, 4.0,
                                                                                              5.0, 6.0]


def test_retention_with_async_save_spares_the_resume_source(assets, runs):
    """Resuming from ``step_4`` of a run, into that run's output directory, with
    ``keep_last_n_checkpoints: 1`` and ``async_save``: the kept newest step and
    the resume source stay, every older step is pruned."""
    root = assets[0]
    src = root / "port_retention"
    import shutil

    shutil.copytree(root / "port_half", src)
    cfg = cfg_dict(src / "step_4", src, assets[2], max_steps=8, save_steps=2, eval_steps=2,
                   keep_last_n_checkpoints=1, async_save=True)
    cfg["checkpointer"]["training_state_checkpoint"] = str(root / "port_half" / "training_state.msgpack")
    t, rest, _ = run(Trainer, cfg)
    assert t.global_step == 8
    assert sorted(p.name for p in src.glob("step_*")) == ["step_4", "step_8"]
    assert (src / "step_8" / "ft-model-00001-of-00001.safetensors").read_bytes() == \
        (root / "port_full" / "step_8" / "ft-model-00001-of-00001.safetensors").read_bytes()
    assert msgpack_io.load(src / "training_state.msgpack")["global_step"] == 8


def test_final_checkpoint_at_max_steps(assets):
    t, losses, _ = port_run(assets, "port_final", max_steps=5, save_steps=4, eval_steps=4)
    assert len(losses) == 5
    assert sorted(p.name for p in (assets[0] / "port_final").glob("step_*")) == ["step_4", "step_5"]


def test_hparam_mismatch_on_resume_raises(assets, runs):
    root = assets[0]
    with pytest.raises(ValueError, match="Training hparam mismatch on resume: 'batch_size'"):
        resume(Trainer, assets, "port_mismatch", root / "port_half",
               data={"train": {"dataloader": {"batch_size": 3}}})
    t, rest, _ = resume(Trainer, assets, "port_forced", root / "port_half", max_steps=5, force_resume=True,
                        data={"train": {"dataloader": {"batch_size": 3}}})
    assert t.global_step == 5 and len(rest) == 1


def test_zero_token_window_applies_no_update(assets):
    root, model_dir, split, _ = assets
    t = Trainer(PortConfig(cfg_dict(model_dir, root / "port_zero", split)))
    t.setup()
    window = [next(iter(t.data_train)) for _ in range(2)]
    for batch in window:
        batch["labels"][:] = -100
    before = {k: v.clone() for k, v in t.state["params"]["layers"].items()}
    t._optimizer_step(0, 1, window)
    assert (t.global_step, t.consumed_windows, t.consumed_samples, t.state["step"]) == (0, 1, 0, 0)
    assert t.state["opt_state"]["count"] == 0
    assert all(torch.equal(v, before[k]) for k, v in t.state["params"]["layers"].items())
    t.cleanup()


def test_profiler_key_writes_a_trace(assets):
    root = assets[0]
    t, _, _ = port_run(assets, "port_profile", max_steps=3, save_steps=3, eval_steps=3,
                       profiler={"start_step": 1, "num_steps": 1, "dir": str(root / "trace")})
    assert t.profile_trace == root / "trace" / "trace_rank0.json"
    events = json.loads(t.profile_trace.read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert t.profile_wall_s > 0


def test_default_device_refuses_without_a_card(assets, monkeypatch):
    root, model_dir, split, _ = assets
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = cfg_dict(model_dir, root / "port_nocard", split)
    del cfg["device"]
    with pytest.raises(RuntimeError, match=r"\+device=cpu"):
        Trainer(PortConfig(cfg)).setup()
    assert not (root / "port_nocard").exists()


@pytest.mark.parametrize("over,error,match", [
    ({"parallel": {"dp": 2}}, ValueError, r"^Requested dp\*tp = 2 exceeds available devices \(1\)$"),
    ({"parallel": {"tp": 2}}, ValueError, r"^Requested dp\*tp = 2 exceeds available devices \(1\)$"),
    ({"attn_impl": "pallas"}, ValueError, "attn_impl=auto"),
])
def test_unported_keys_raise(assets, over, error, match):
    """An explicit attention raises before any work; dp or tp beyond the
    world size raises the JAX ``make_mesh`` error rather than train on one
    rank."""
    root, model_dir, split, _ = assets
    with pytest.raises(error, match=match):
        Trainer(PortConfig(cfg_dict(model_dir, root / "port_refused", split, **over))).setup()


def world_1_group() -> dict:
    """``parallel`` keys of a one-rank process group (gloo, a free port)."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    return {"distributed": True, "coordinator_address": f"localhost:{port}", "num_processes": 1, "process_id": 0}


@pytest.mark.parametrize("flag", ["zero1", "fsdp"])
def test_zero1_and_fsdp_at_world_size_1_equal_the_plain_run(assets, runs, flag):
    """At one rank (a gloo group of one) ZeRO-1 and FSDP shard nothing and
    every collective is the identity: losses, logged values, ``step_4/`` and
    the optimizer state equal the plain run's bit for bit."""
    root = assets[0]
    t, losses, hist = port_run(assets, f"port_{flag}_w1", max_steps=4, save_steps=2, eval_steps=2,
                               parallel={flag: True, **world_1_group()})
    assert t.distributed and t.world_size == 1
    assert all(d is None for d in popt.tree_leaves(t.layout.params) + popt.tree_leaves(t.layout.moments))
    _, half, half_hist = runs["port_half"]
    assert losses == half and strip_timing(hist) == strip_timing(half_hist)
    assert (root / f"port_{flag}_w1" / "step_4" / "ft-model-00001-of-00001.safetensors").read_bytes() == \
        (root / "port_half" / "step_4" / "ft-model-00001-of-00001.safetensors").read_bytes()
    got = msgpack_io.load(root / f"port_{flag}_w1" / "training_state.msgpack")["optimizer"]
    want = msgpack_io.load(root / "port_half" / "training_state.msgpack")["optimizer"]
    assert msgpack_io.pack(got) == msgpack_io.pack(want)


def test_sharded_optimizer_state_at_world_size_1_resumes_bitwise(assets, runs):
    """``sharded_optimizer_state`` at one rank: the state file holds the
    port's directory marker, only the newest directory stays, and a resume
    from step 4 runs steps 5-8 equal to the uninterrupted run's, bitwise."""
    from ssi_tpu_torch.checkpoint import sharded_io

    root = assets[0]
    _, half, _ = runs["port_half"]
    _, full, _ = runs["port_full"]
    _, losses, _ = port_run(assets, "port_sharded_half", max_steps=4, save_steps=2, eval_steps=2,
                            sharded_optimizer_state=True)
    assert losses == half
    marker = msgpack_io.load(root / "port_sharded_half" / "training_state.msgpack")["optimizer"]
    assert sharded_io.is_marker(marker) and marker == {sharded_io.DCP_DIR_KEY: "optimizer_state_dcp_step4"}
    assert [p.name for p in (root / "port_sharded_half").glob("optimizer_state_dcp_step*")] == [
        "optimizer_state_dcp_step4"]
    t, rest, _ = resume(Trainer, assets, "port_sharded_resumed", root / "port_sharded_half",
                        sharded_optimizer_state=True)
    assert t.global_step == 8 and half + rest == full
    assert (root / "port_sharded_resumed" / "step_8" / "ft-model-00001-of-00001.safetensors").read_bytes() == \
        (root / "port_full" / "step_8" / "ft-model-00001-of-00001.safetensors").read_bytes()


def test_an_orbax_state_raises_naming_the_shared_route(assets, runs, tmp_path):
    """The JAX package's Orbax marker on resume: a ValueError that names it
    and the msgpack route both packages read."""
    root = assets[0]
    state = msgpack_io.load(root / "port_half" / "training_state.msgpack")
    state["optimizer"] = {"__orbax_dir__": "optimizer_state_orbax_step4"}
    path = tmp_path / "training_state.msgpack"
    path.write_bytes(msgpack_io.pack(state))
    with pytest.raises(ValueError, match=r"Orbax format.*sharded_optimizer_state: false"):
        cfg = cfg_dict(root / "port_half" / "step_4", root / "port_orbax", assets[2])
        cfg["checkpointer"]["training_state_checkpoint"] = str(path)
        Trainer(PortConfig(cfg)).setup()


# --- the copied host modules --------------------------------------------------------------


def test_train_utils_copies_equal(assets):
    for n_dsus, modality in ((16, True), (5000, True), (0, False)):
        jcfg = helpers.tiny_config(n_dsus, modality)
        from ssi_tpu_torch.models.configs import get_model_config

        pcfg = get_model_config("tiny_test")
        pcfg.n_dsus, pcfg.modality_tokens = n_dsus, modality
        assert putils.get_token_type_ranges(pcfg) == jutils.get_token_type_ranges(jcfg)
        ranges = putils.get_token_type_ranges(pcfg)
        tokens = np.random.default_rng(n_dsus).integers(0, pcfg.vocab_size, (3, 40))
        assert putils.count_token_types(tokens, ranges, 0) == jutils.count_token_types(tokens, ranges, 0)
    root, model_dir, split, _ = assets
    for over in ({}, {"save_steps": 4}, {"max_steps": 0}, {"dtype": "fp16"}, {"speech": {"n_dsus": None}}):
        d = cfg_dict(model_dir, root / "unused", **over)
        errors = []
        for utils, config in ((putils, PortConfig), (jutils, JaxConfig)):
            try:
                utils.validate_train_cfg(config(copy.deepcopy(d)))
                errors.append(None)
            except ValueError as e:
                errors.append(str(e))
        assert errors[0] == errors[1], over
    d = cfg_dict(model_dir, root / "unused", speech={"n_dsus": None})
    p, j = PortConfig(copy.deepcopy(d)), JaxConfig(copy.deepcopy(d))
    putils.resolve_n_dsus(p)
    jutils.resolve_n_dsus(j)
    assert p.speech.n_dsus == j.speech.n_dsus == helpers.TINY_N_DSUS
    state = {"checkpoint_version": 1, "global_step": 3, "seed": 42_831, "optimizer": {}, "lr_scheduler": None,
             "rng_state": None, "training_hparams": {}, "consumed_samples": 6, "cumulative_metrics": {}}
    assert putils.resume_training_state(state) == jutils.resume_training_state(state)
    for bad in ({"checkpoint_version": 2}, {"seed": 1}):
        with pytest.raises(ValueError) as pe:
            putils.resume_training_state({**state, **bad})
        with pytest.raises(ValueError) as je:
            jutils.resume_training_state({**state, **bad})
        assert str(pe.value) == str(je.value)


@pytest.mark.parametrize("sched", [None, {"num_warmup_steps": 3}, {"type": "cosine", "num_warmup_steps": 2,
                                                                    "num_cycles": 1.5},
                                   {"type": "wsd", "num_warmup_steps": 2, "decay_fraction": 0.3, "min_lr_ratio": 0.1}])
def test_lr_schedule_and_optimizer_from_config_equal(sched):
    d = {"optimizer": {"lr": 3e-4, "betas": [0.8, 0.95], "eps": 1e-7, "weight_decay": 0.1, "mu_dtype": "fp32",
                       "nu_dtype": "bf16", "stochastic_rounding": True}, "lr_scheduler": sched}
    p, j = psched.setup_lr_schedule(PortConfig(d), 20), jsched.setup_lr_schedule(JaxConfig(d), 20)
    assert [p(s) for s in range(22)] == [float(j(s)) for s in range(22)]
    pc, jc = popt.AdamWConfig.from_cfg(PortConfig(d).optimizer), jopt.AdamWConfig.from_cfg(JaxConfig(d).optimizer)
    assert (pc.lr, pc.b1, pc.b2, pc.eps, pc.weight_decay, pc.stochastic_rounding) == \
        (jc.lr, jc.b1, jc.b2, jc.eps, jc.weight_decay, jc.stochastic_rounding)
    assert (pc.mu_dtype, pc.nu_dtype) == (torch.float32, torch.bfloat16)


def test_metric_logger_falls_back_to_jsonl_without_wandb(tmp_path, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_wandb(name, *args, **kwargs):
        if name == "wandb":
            raise ImportError("No module named 'wandb'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_wandb)
    logger = setup_metric_logger({"enabled": True, "project": "p"}, log_dir=tmp_path)
    assert type(logger) is JsonlLogger
    logger.log_dict({"loss": 1.5, "x": np.float32(2.0)}, step=3)
    logger.close()
    assert json.loads((tmp_path / "metrics.jsonl").read_text()) == {"step": 3, "loss": 1.5, "x": 2.0}
    assert type(setup_metric_logger({"enabled": False})) is JsonlLogger


def test_copied_constants_equal():
    import ssi_tpu.constants as jconst
    import ssi_tpu_torch.constants as pconst

    names = [n for n in dir(pconst) if n.isupper()]
    assert {"SEED", "CHECKPOINT_VERSION", "RNG_KEY", "LLAMA_BOS_TOKEN", "EXTENDED_MODELS_DIR"} <= set(names)
    for name in names:
        assert getattr(pconst, name) == getattr(jconst, name), name
