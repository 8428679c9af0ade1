"""Sharded optimizer-state checkpointing: the port of
``ssi_tpu/checkpoint/orbax_io.py`` on ``torch.distributed.checkpoint``.

The default resume state gathers the whole optimizer state to rank 0 and
writes it into the msgpack file (the JAX package's bytes: either package
resumes the other's). With ``sharded_optimizer_state: true`` every rank
writes its own slices instead: each moment is a DTensor on a 2-D
``DeviceMesh`` over the ranks with dimensions ``("tp", "dp")``, placed
``Shard(dim)`` on each mesh dimension that cuts it (``Replicate()`` on one
that does not; a leaf whole on every rank is written once). The mesh is
ordered tp-major, as the JAX ``("tp", "dp")`` co-sharding cuts a dimension
that both axes shard: DTensor cuts such a dimension in mesh order, first
into the tp slices, then each into its dp slices, which is where the
training layout puts the bytes. A restore reads into the resuming run's
layout, whatever its dp and tp (or with no process group, into whole
tensors).

The msgpack file keeps everything else (RNG states, counters, hparams), and
its ``optimizer`` entry becomes ``{"__ssi_tpu_torch_dcp_dir__": <directory
relative to the state file>}``: the port's own key, so that neither package
takes the other's directory for its own. The format is the port's only; the
msgpack route (``sharded_optimizer_state: false``) is the one both packages
read. Round-trips are bitwise: the files hold the tensors' raw bytes.
"""

from __future__ import annotations

import logging
from pathlib import Path
import shutil
from typing import Any

import torch
import torch.distributed as dist

from ssi_tpu_torch.parallel import StateLayout, map_trees

LOGGER = logging.getLogger(__name__)

DCP_DIR_KEY = "__ssi_tpu_torch_dcp_dir__"
ORBAX_DIR_KEY = "__orbax_dir__"  # the JAX package's marker of an Orbax-sharded optimizer state
_DIR_PREFIX = "optimizer_state_dcp_step"


def is_marker(optimizer_state: Any) -> bool:
    return isinstance(optimizer_state, dict) and DCP_DIR_KEY in optimizer_state


def refuse_orbax_marker(optimizer_state: Any, state_path: Path | str) -> None:
    """Raise on the JAX package's Orbax marker, which the port does not read."""
    if isinstance(optimizer_state, dict) and ORBAX_DIR_KEY in optimizer_state:
        raise ValueError(
            f"The optimizer state in {state_path} is an Orbax directory ({optimizer_state[ORBAX_DIR_KEY]!r}): the "
            "JAX package's Orbax format, which ssi_tpu_torch does not read. The msgpack route "
            "(sharded_optimizer_state: false) is the one both packages read: save the state that way to resume it "
            "here."
        )


def _leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


def _strides(shape) -> tuple[int, ...]:
    out, s = [], 1
    for n in reversed(shape):
        out.append(s)
        s *= n
    return tuple(reversed(out))


def _state_dict(mu: Any, nu: Any, count: int, layout: StateLayout) -> dict[str, Any]:
    """The optimizer state as DCP sees it: each moment a DTensor over the
    ranks (when a process group is up), ``count`` a replicated 0-d tensor.
    The DTensors wrap this rank's tensors, so a load fills them in place."""
    if not dist.is_initialized():
        wrap = lambda t, d, td, shape: t  # noqa: E731
    else:
        from torch.distributed.device_mesh import DeviceMesh
        from torch.distributed.tensor import DTensor, Replicate, Shard

        mesh = layout.mesh
        # rank r sits at (tp index r % tp, dp index r // tp): the mesh tensor tp-major
        ranks = torch.arange(mesh.dp * mesh.tp).view(mesh.dp, mesh.tp).t().contiguous()
        dev_mesh = DeviceMesh(_leaves(mu)[0].device.type, ranks, mesh_dim_names=("tp", "dp"))

        def wrap(t, d, td, shape):
            placements = [Replicate() if td is None else Shard(td), Replicate() if d is None else Shard(d)]
            return DTensor.from_local(t, dev_mesh, placements, run_check=False, shape=torch.Size(shape),
                                      stride=_strides(shape))

    dims, tps, shapes = layout.moments, layout.tp, layout.shapes
    return {"mu": map_trees(wrap, mu, dims, tps, shapes), "nu": map_trees(wrap, nu, dims, tps, shapes),
            "count": torch.tensor(count, dtype=torch.int32)}


def save_opt_state(opt_state: dict[str, Any], layout: StateLayout, output_dir: Path, step: int) -> dict[str, str]:
    """Collective sharded save: every rank writes its own slices (``layout``:
    the run's ``StateLayout``, whose moments the state holds). Returns the
    msgpack marker. Every rank must call it."""
    import torch.distributed.checkpoint as dcp

    rel = f"{_DIR_PREFIX}{step}"
    path = (Path(output_dir) / rel).resolve()
    rank = dist.get_rank() if dist.is_initialized() else 0
    # A crash between this save and the msgpack commit leaves a stale directory
    # for the same step, which no state file references: remove it (rank 0)
    # before every rank writes, and let no rank start writing before that.
    if rank == 0 and path.exists():
        LOGGER.warning("Removing stale uncommitted optimizer dir %s", path)
        shutil.rmtree(path, ignore_errors=True)
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
    sd = _state_dict(opt_state["mu"], opt_state["nu"], int(opt_state["count"]), layout)
    dcp.save(sd, checkpoint_id=str(path), no_dist=not dist.is_initialized())
    return {DCP_DIR_KEY: rel}


def prune_old_opt_states(output_dir: Path, keep_step: int) -> None:
    """Delete superseded sharded optimizer directories (call after the state
    msgpack referencing ``keep_step`` has been written; rank 0 only)."""
    keep = f"{_DIR_PREFIX}{keep_step}"
    for d in Path(output_dir).glob(f"{_DIR_PREFIX}*"):
        if d.is_dir() and d.name != keep:
            shutil.rmtree(d, ignore_errors=True)


def restore_opt_state(marker: dict[str, str], state_dir: Path, like: dict[str, Any],
                      layout: StateLayout) -> dict[str, Any]:
    """Read a sharded optimizer state into this run's layout.

    ``state_dir``: the directory of the state msgpack (markers are relative
    to it); ``like``: ``{"mu", "nu"}`` trees of this rank's moment tensors
    (their shapes, dtypes and device), filled in place; ``layout`` as for
    :func:`save_opt_state`. DCP re-shards on read: each rank reads the bytes
    of its own slices, whatever the saving run's dp and tp."""
    import torch.distributed.checkpoint as dcp

    path = (Path(state_dir) / marker[DCP_DIR_KEY]).resolve()
    if not path.exists():
        raise FileNotFoundError(f"Sharded optimizer state {path} not found (marker {marker!r} in {state_dir})")
    sd = _state_dict(like["mu"], like["nu"], 0, layout)
    dcp.load(sd, checkpoint_id=str(path), no_dist=not dist.is_initialized())
    return {"mu": like["mu"], "nu": like["nu"], "count": int(sd["count"])}
