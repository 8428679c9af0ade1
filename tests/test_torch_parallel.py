"""The port's dp layout rules and process-group gating
(``ssi_tpu_torch/parallel/__init__.py``) against the JAX package's
(``ssi_tpu/parallel/__init__.py``), on the host.

Held: for every leaf of ``helpers.tiny_config()``, ``llama3_2_1b``,
``llama3_2_3b`` and ``llama3_1_8b`` (5,000 DSUs and the modality tokens, as
the SFT runs extend them; shapes from ``jax.eval_shape``, nothing allocated)
at dp 1, 2, 3, 4 and 8, the port's parameter specs with and without FSDP and
its moment specs with and without ZeRO-1 equal the JAX rules' (which read
only ``mesh.shape``), and the dimension the port shards is the one the JAX
spec puts "dp" on; ``make_mesh``'s checks and ``initialize_distributed``'s
gating and error texts are the JAX functions' (launcher variables in place of
``JAX_*``), and a world-1 gloo group comes up, idempotently.
"""

import types

import jax
import pytest
import torch.distributed as dist

from ssi_tpu import parallel as jpar
from ssi_tpu.models import configs as jconfigs
from ssi_tpu.models.llama3 import init_params as jax_init_params
from ssi_tpu_torch import parallel as ppar
from ssi_tpu_torch.train.optimizer import tree_leaves
from tests import helpers

CONFIGS = ("tiny", "llama3_2_1b", "llama3_2_3b", "llama3_1_8b")
LAUNCH_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK", "JAX_COORDINATOR_ADDRESS",
               "JAX_NUM_PROCESSES", "JAX_PROCESS_ID", "TPU_WORKER_HOSTNAMES", "MEGASCALE_COORDINATOR_ADDRESS",
               "SLURM_JOB_NUM_NODES")


def jax_config(name: str):
    if name == "tiny":
        return helpers.tiny_config()
    cfg = jconfigs.get_model_config(name).copy()
    cfg.n_dsus, cfg.modality_tokens = 5000, True
    return cfg


def jax_shapes(name: str):
    cfg = jax_config(name)
    return jax.eval_shape(lambda: jax_init_params(cfg, jax.random.PRNGKey(0)))


def to_shapes(tree):
    return {k: to_shapes(v) for k, v in tree.items()} if isinstance(tree, dict) else tuple(tree.shape)


@pytest.mark.parametrize("dp", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("name", CONFIGS)
def test_layout_rules_equal_the_jax_rules(name, dp):
    shapes = jax_shapes(name)
    mesh = types.SimpleNamespace(shape={"dp": dp, "tp": 1})
    port_mesh = ppar.Mesh(dp=dp, tp=1)
    base = jax.tree.map(lambda spec, leaf: jpar._divisible_spec(spec, leaf.shape, mesh), jpar.param_specs(shapes),
                        shapes, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    want = {
        "params": base,
        "fsdp": jax.tree.map(lambda s, leaf: jpar._zero1_spec(s, leaf.shape, mesh), base, shapes,
                             is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)),
    }
    port_shapes = to_shapes(shapes)
    heads = {"num_kv_heads": jax_config(name).num_kv_heads}
    got = {"params": ppar.param_shardings(port_mesh, port_shapes, **heads),
           "fsdp": ppar.param_shardings(port_mesh, port_shapes, fsdp=True, **heads)}
    moments = ppar.opt_state_shardings(port_mesh, port_shapes, zero1=True, **heads)
    assert moments["count"] == () and moments["mu"] == moments["nu"]
    assert ppar.opt_state_shardings(port_mesh, port_shapes, **heads)["mu"] == got["params"]
    got["zero1"], want["zero1"] = moments["mu"], want["fsdp"]  # the JAX moments take the same augmentation
    layout = ppar.StateLayout.build(port_mesh, port_shapes, zero1=True, fsdp=True, **heads)
    sharded = 0
    for key in ("params", "fsdp", "zero1"):
        j_leaves = jax.tree.leaves(want[key], is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        p_leaves = jax.tree.leaves(got[key], is_leaf=lambda x: isinstance(x, tuple))
        assert len(j_leaves) == len(p_leaves)
        for j, p in zip(j_leaves, p_leaves):
            assert tuple(j) == p
    for j, d, shape in zip(jax.tree.leaves(want["fsdp"], is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)),
                           tree_leaves(layout.params), jax.tree.leaves(shapes)):
        axes = list(j)
        want_dim = next((i for i, a in enumerate(axes) if a == "dp" or (isinstance(a, tuple) and "dp" in a)), None)
        assert d == want_dim
        if d is not None:
            assert shape.shape[d] % dp == 0
            sharded += 1
    if dp == 1:
        assert sharded == 0
    elif name != "tiny" and dp in (2, 4, 8):
        assert sharded == len(jax.tree.leaves(shapes))  # every 1B-8B leaf divides at these dp


def test_make_mesh_checks_equal_the_jax_ones():
    assert ppar.make_mesh(world_size=4).shape == {"dp": 4, "tp": 1}
    assert ppar.make_mesh(dp=2, world_size=2, rank=1) == ppar.Mesh(dp=2, tp=1, rank=1)
    devices = jax.devices()[:1]
    with pytest.raises(ValueError) as j:
        jpar.make_mesh(dp=2, tp=1, devices=devices)
    with pytest.raises(ValueError) as p:
        ppar.make_mesh(dp=2, world_size=1)
    assert str(p.value) == str(j.value) == "Requested dp*tp = 2 exceeds available devices (1)"
    # tp > 1 (serving): rank r holds tp index r % tp, as the JAX device grid reshape(dp, tp)
    mesh = ppar.make_mesh(tp=2, world_size=4, rank=3)
    assert mesh == ppar.Mesh(dp=2, tp=2, rank=3) and mesh.tp_rank == 1 and mesh.groups is None
    assert jpar.make_mesh(tp=2, devices=jax.devices()[:4]).devices.shape == (2, 2)
    with pytest.raises(ValueError) as j:
        jpar.make_mesh(tp=3, devices=jax.devices()[:4])
    with pytest.raises(ValueError) as p:
        ppar.make_mesh(tp=3, world_size=4)
    assert str(p.value) == str(j.value) == "Device count 4 not divisible by tp=3"


@pytest.fixture
def no_launcher(monkeypatch):
    for var in LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)


@pytest.mark.parametrize("cfg", [None, {"distributed": False}, {"distributed": "auto"}, {"distributed": "off"}])
def test_gating_that_stays_single_process_equals_jax(no_launcher, cfg):
    assert ppar.initialize_distributed(cfg, "cpu") is False
    assert jpar.initialize_distributed(cfg) is False
    assert not dist.is_initialized()


@pytest.mark.parametrize("cfg", [
    {"distributed": "maybe", "coordinator_address": "localhost:1"},
    {"distributed": True, "coordinator_address": "localhost:1"},
    {"distributed": "auto", "coordinator_address": "localhost:1", "num_processes": 2},
])
def test_gating_errors_equal_jax(no_launcher, cfg):
    with pytest.raises(ValueError) as j:
        jpar.initialize_distributed(cfg)
    with pytest.raises(ValueError) as p:
        ppar.initialize_distributed(cfg, "cpu")
    assert str(p.value) == str(j.value).replace("JAX_NUM_PROCESSES / JAX_PROCESS_ID", "WORLD_SIZE / RANK")
    assert not dist.is_initialized()


def test_true_without_a_launcher_raises_and_a_launcher_env_counts(no_launcher, monkeypatch):
    with pytest.raises(ValueError, match="torchrun sets MASTER_ADDR"):
        ppar.initialize_distributed({"distributed": True}, "cpu")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="WORLD_SIZE / RANK"):
        ppar.initialize_distributed({"distributed": "auto"}, "cpu")
    assert not dist.is_initialized()


def test_a_world_1_gloo_group_comes_up_idempotently(no_launcher, monkeypatch):
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(port))
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    try:
        assert ppar.initialize_distributed(None, "cpu") is False  # auto, from the launcher's variables
        assert dist.is_initialized() and dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        assert ppar.initialize_distributed({"distributed": True}, "cpu") is False
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
