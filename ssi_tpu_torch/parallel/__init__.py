"""Ranks, the dp x tp mesh and the dp-sharded layout of the training state:
the port of ``ssi_tpu/parallel/__init__.py`` on ``torch.distributed``.

A port rank is one process and one device (PyTorch's idiom: ``torchrun
--nproc_per_node N -m ssi_tpu_torch.cli.train_sft ...``), so a JAX *process*
maps to a port *rank*, and the mesh's "devices" are the ranks. The backend is
NCCL on CUDA and gloo on the CPU; a CUDA run that cannot bring NCCL up fails.

Layout rules, kept from the JAX package so that the sharded state's layout is
its layout:

- ``param_specs`` gives each leaf its tp axes (``"tp"`` on the head/ffn or
  vocab dimension), ``_divisible_spec`` drops an axis that does not divide its
  dimension, and ``_zero1_spec`` adds ``"dp"`` on the first dimension that is
  unsharded and divisible by dp (else co-shards a tp dimension that dp x tp
  divides). A spec is a tuple of axes (``None``, a name, or a tuple of names)
  with ``PartitionSpec``'s entries.
- ZeRO-1 shards the AdamW moments by that rule; FSDP shards the resident
  parameters too. At tp 1 the layer-stacked ``[L, ...]`` weights shard along
  L when L % dp == 0, and the embedding along D.
- A rank holds the slice of its dp index among dp equal slices of a
  dp-sharded dimension; a dimension co-sharded ``("tp", "dp")`` is cut
  tp-major: the rank's tp slice, then its dp slice of that.

Tensor parallelism (Megatron's layout): rank ``r`` of a ``(dp, tp)`` mesh
holds tp index ``r % tp`` and dp index ``r // tp`` (the JAX
``device_grid.reshape(dp, tp)``), ``tp_shard`` cuts its slice of a leaf by
the specs above, and the tp collectives run over its tp group. Serving
(``generate/paged_engine.py`` with a ``mesh``) takes ``tp_all_reduce`` /
``tp_all_gather`` (no autograd); training takes ``copy_to_tp`` (identity
forward, all-reduce backward) before the column-split products and
``reduce_from_tp`` (all-reduce forward, identity backward) after the
row-split ones, and its dp collectives (``gather``, ``reduce_scatter``,
the step's all-reduces) run over the rank's dp column. Not ported:
``dcn_slices`` (TPU slice topology: NCCL's own rings and trees do the
hierarchical reduction the JAX code gets from slice-major order).
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field
from datetime import timedelta
import logging
import os
from typing import Any

import torch
import torch.distributed as dist

LOGGER = logging.getLogger(__name__)

__all__ = [
    "Mesh",
    "StateLayout",
    "initialize_distributed",
    "joined_from_launcher",
    "make_mesh",
    "MeshGroups",
    "param_specs",
    "tp_shard",
    "tp_local_shape",
    "tp_all_reduce",
    "tp_all_gather",
    "copy_to_tp",
    "reduce_from_tp",
    "TensorParallel",
    "param_shardings",
    "opt_state_shardings",
    "shard_dim",
    "shard",
    "gather",
    "reduce_scatter",
    "shard_params",
    "full_host_copy",
    "map_trees",
    "LeafShard",
    "LayerShard",
]

Spec = tuple  # a PartitionSpec's entries


def initialize_distributed(parallel_cfg: Any = None, device: torch.device | str = "cuda") -> bool:
    """Bring up the process group: the port of the JAX ``initialize_distributed``.

    Gating (``parallel.distributed``, default "auto"):

    - ``false``: never initialize (one process);
    - ``auto``: initialize iff explicit settings are present
      (``parallel.coordinator_address`` / ``num_processes`` / ``process_id``,
      or a launcher's ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` /
      ``RANK``, which ``torchrun`` sets);
    - ``true``: always initialize; without those settings it raises (the
      port has no cluster auto-detection).

    The group joins over TCP at ``coordinator_address`` (``host:port``), with
    NCCL when ``device`` is CUDA (after ``torch.cuda.set_device(LOCAL_RANK)``)
    and gloo on the CPU; a failure raises (no single-process fallback).
    Returns True when running with more than one rank. Idempotent.
    """
    get = parallel_cfg.get if parallel_cfg is not None else (lambda *_: None)
    mode = get("distributed")
    mode = "auto" if mode is None else str(mode).lower()
    if mode in ("false", "off", "0", "no"):
        return False
    if dist.is_initialized():
        return dist.get_world_size() > 1

    coord = get("coordinator_address")
    if coord is None and os.getenv("MASTER_ADDR"):
        coord = f"{os.environ['MASTER_ADDR']}:{os.getenv('MASTER_PORT', '29500')}"
    nproc = get("num_processes") or os.getenv("WORLD_SIZE")
    pid = get("process_id")
    if pid is None:
        pid = os.getenv("RANK")
    explicit = coord is not None
    if mode == "auto" and not explicit:
        return False
    if mode not in ("auto", "true", "on", "1", "yes"):
        raise ValueError(f"parallel.distributed must be bool or 'auto', got {mode!r}")
    if not explicit:
        raise ValueError(
            "parallel.distributed=true needs a launcher's environment (torchrun sets MASTER_ADDR, MASTER_PORT, "
            "WORLD_SIZE and RANK) or parallel.coordinator_address with parallel.num_processes and "
            "parallel.process_id: the port has no cluster auto-detection"
        )
    if nproc is None or pid is None:
        raise ValueError(
            "parallel.coordinator_address is set but num_processes/process_id are not — "
            "set parallel.num_processes and parallel.process_id (or the "
            "WORLD_SIZE / RANK env vars) alongside it."
        )
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(int(os.getenv("LOCAL_RANK", int(pid) % torch.cuda.device_count())))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method=f"tcp://{coord}",
                            world_size=int(nproc), rank=int(pid))
    LOGGER.info(f"torch.distributed initialized ({dist.get_backend()}): rank {dist.get_rank()}/"
                f"{dist.get_world_size()}")
    return dist.get_world_size() > 1


@contextmanager
def joined_from_launcher(device: torch.device | str):
    """The process group of a launcher's environment (torchrun's) around an
    entry point's body: joined by ``initialize_distributed`` (nothing without
    one) and destroyed when the body ends, unless it was joined before."""
    own = not dist.is_initialized()
    initialize_distributed(None, device)
    try:
        yield
    finally:
        if own and dist.is_initialized():
            dist.destroy_process_group()


@dataclass(frozen=True)
class MeshGroups:
    """This rank's process groups on a mesh: its tp block (the tp index runs
    fastest), its dp column, and a gloo side group over the tp block for the
    serving engine's host messages (None where the block is one rank)."""

    tp: Any
    dp: Any
    tp_ctrl: Any = None
    tp_root: int = 0  # the global rank of tp index 0 in this rank's block


@dataclass(frozen=True)
class Mesh:
    """The ("dp", "tp") mesh over the ranks, and this process's rank in it.
    ``groups`` is None without a process group (every collective an identity)."""

    dp: int
    tp: int
    rank: int = 0
    groups: MeshGroups | None = field(default=None, compare=False, repr=False)

    @property
    def shape(self) -> dict[str, int]:
        return {"dp": self.dp, "tp": self.tp}

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_group(self) -> Any:
        return self.groups.tp if self.groups is not None else None

    @property
    def dp_group(self) -> Any:
        """The rank's dp column (None: the world group, as at tp 1)."""
        return self.groups.dp if self.groups is not None else None

    def dp_peer(self, d: int) -> int:
        """The global rank of dp index ``d`` in this rank's dp column."""
        return d * self.tp + self.tp_rank


# host messages wait on the side group while a server idles between requests
_CTRL_TIMEOUT = timedelta(days=30)


def _mesh_groups(dp: int, tp: int, rank: int) -> MeshGroups | None:
    """The groups of a mesh over a joined world: the world group at world
    size 1; with tp > 1 one group per tp block and dp column (every rank
    joins every ``new_group`` call, in one order) plus the gloo side group
    of each tp block; a pure dp mesh has none (``Mesh.dp_group`` is None:
    its dp collectives run over the world group, and nothing is split over
    tp)."""
    if not dist.is_initialized():
        return None
    world = dist.group.WORLD
    if dist.get_world_size() == 1:
        return MeshGroups(tp=world, dp=world)
    if tp == 1:
        return None
    mine = {}
    for d in range(dp):
        ranks = list(range(d * tp, (d + 1) * tp))
        g = dist.new_group(ranks)
        ctrl = dist.new_group(ranks, backend="gloo", timeout=_CTRL_TIMEOUT)
        if rank in ranks:
            mine.update(tp=g, tp_ctrl=ctrl, tp_root=ranks[0])
    for t in range(tp):
        ranks = list(range(t, dp * tp, tp))
        g = dist.new_group(ranks)
        if rank in ranks:
            mine["dp"] = g
    return MeshGroups(**mine)


def make_mesh(dp: int | None = None, tp: int = 1, world_size: int | None = None, rank: int | None = None) -> Mesh:
    """A ("dp", "tp") mesh over ``world_size`` ranks (one device each), with
    the JAX ``make_mesh``'s checks; ``dp=None`` means ``world_size / tp``.
    ``world_size`` and ``rank`` default to the process group's (1 and 0
    without one). Over a joined world of ``dp * tp`` ranks the mesh carries
    its process groups (``_mesh_groups``), which every rank creates together."""
    joined = dist.is_initialized()
    n = world_size if world_size is not None else (dist.get_world_size() if joined else 1)
    if rank is None:
        rank = dist.get_rank() if joined else 0
    if dp is None:
        if n % tp != 0:
            raise ValueError(f"Device count {n} not divisible by tp={tp}")
        dp = n // tp
    dp = int(dp)
    if dp * tp > n:
        raise ValueError(f"Requested dp*tp = {dp * tp} exceeds available devices ({n})")
    if dp * tp < n:
        LOGGER.warning(f"Mesh dp={dp} x tp={tp} uses {dp * tp} of {n} available devices; the rest stay idle.")
    groups = _mesh_groups(dp, tp, rank) if joined and dist.get_world_size() == dp * tp else None
    return Mesh(dp=dp, tp=tp, rank=rank, groups=groups)


# --- layout rules (the JAX package's, line for line) ----------------------------------------------


def map_trees(fn, *trees):
    """``fn`` over the leaves of nested dicts of one shape, leaf by leaf."""
    if isinstance(trees[0], dict):
        return {k: map_trees(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def param_specs(params: Any) -> Any:
    """The spec tree for the stacked Llama params (tp sharding rules)."""
    specs = {
        "embed": ("tp", None),  # vocab-sharded: distributes fused-CE logits too
        "lm_head": ("tp", None),  # untied output head (8B): same vocab sharding
        "final_norm": (),
        "layers": {
            "attn_norm": (),
            "mlp_norm": (),
            "wq": (None, None, "tp"),
            "wk": (None, None, "tp"),
            "wv": (None, None, "tp"),
            "wo": (None, "tp", None),
            "w_gate": (None, None, "tp"),
            "w_up": (None, None, "tp"),
            "w_down": (None, "tp", None),
        },
    }

    def pick(node, tree):
        return {k: pick(node[k], v) for k, v in tree.items()} if isinstance(tree, dict) else node

    return pick(specs, params)


def _divisible_spec(spec: Spec, shape: tuple[int, ...], mesh: Mesh) -> Spec:
    """Drop mesh axes that do not divide the corresponding array dimension
    (replicate that dimension rather than fail)."""
    out = []
    changed = False
    for dim, axis in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if axis is not None and dim % mesh.shape[axis] != 0:
            LOGGER.warning(
                f"Array dim {dim} not divisible by mesh axis {axis!r}={mesh.shape[axis]}; replicating that dim."
            )
            out.append(None)
            changed = True
        else:
            out.append(axis)
    return tuple(out) if changed else spec


def _zero1_spec(spec: Spec, shape: tuple[int, ...], mesh: Mesh) -> Spec:
    """Augment a (tp-resolved) spec with "dp" on the first shardable dimension:
    the first dimension that is unsharded and divisible by dp; else co-shard a
    tp-sharded dimension as ("tp", "dp") when divisible by tp*dp; else leave
    the leaf as it is."""
    dp = mesh.shape["dp"]
    if dp == 1:
        return spec
    axes = list(tuple(spec) + (None,) * (len(shape) - len(spec)))
    for i, (dim, ax) in enumerate(zip(shape, axes)):
        if ax is None and dim % dp == 0:
            axes[i] = "dp"
            return tuple(axes)
    for i, (dim, ax) in enumerate(zip(shape, axes)):
        if ax == "tp" and dim % (dp * mesh.shape["tp"]) == 0:
            axes[i] = ("tp", "dp")
            return tuple(axes)
    return spec


def _shape(leaf: Any) -> tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def param_shardings(mesh: Mesh, params: Any, *, num_kv_heads: int, fsdp: bool = False) -> Any:
    """The spec tree of the parameters, the tensor-parallel compute layout of
    training and serving; ``fsdp`` adds dp, so that resident parameters,
    gradients and moments all divide by dp. ``params``' leaves may be
    tensors or shapes.

    The tp layout is the JAX ``param_specs`` through ``_divisible_spec``, so
    a dimension tp does not divide is replicated (the extended vocabulary
    133,258 at tp 4 keeps ``embed`` whole), with one departure: the JAX
    package shards the kv feature axis whenever tp divides it, even through
    a head, while here a rank holds whole kv heads. Where tp does not divide
    ``num_kv_heads`` attention stays whole on every rank (``wq``/``wk``/
    ``wv``/``wo`` and the serving pools replicated, no collective around
    attention). The result is the same; only the layout differs."""
    base = map_trees(lambda spec, leaf: _divisible_spec(spec, _shape(leaf), mesh), param_specs(params), params)
    if num_kv_heads % mesh.tp:
        for name in ("wq", "wk", "wv", "wo"):
            base["layers"][name] = ()
    if not fsdp:
        return base
    return map_trees(lambda spec, leaf: _zero1_spec(spec, _shape(leaf), mesh), base, params)


def opt_state_shardings(mesh: Mesh, params: Any, *, num_kv_heads: int, zero1: bool = False) -> dict[str, Any]:
    """The spec trees of the AdamW state ({mu, nu, count}): the moments shard
    like their parameter, and ``zero1`` adds dp to them (ZeRO-1; under FSDP
    the moments get the same augmentation, so zero1=True covers both)."""
    p_specs = param_shardings(mesh, params, num_kv_heads=num_kv_heads)
    moment = map_trees(lambda s, leaf: _zero1_spec(s, _shape(leaf), mesh), p_specs, params) if zero1 else p_specs
    return {"mu": moment, "nu": moment, "count": ()}


def tp_local_shape(shape: tuple[int, ...], spec: Spec, mesh: Mesh) -> tuple[int, ...]:
    """The shape of one rank's slice of a leaf of ``shape`` under ``spec``."""
    spec = _divisible_spec(spec, shape, mesh)
    return tuple(d // mesh.tp if axis == "tp" else d for d, axis in zip(shape, tuple(spec) + (None,) * len(shape)))


def tp_shard(leaf: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of ``leaf`` along every dimension ``spec`` puts
    "tp" on (a view; ``_divisible_spec`` first, so a dimension tp does not
    divide stays whole): the ``r % tp``-th of tp equal slices. At tp 1 the
    leaf itself."""
    if mesh.tp == 1:
        return leaf
    spec = _divisible_spec(spec, tuple(leaf.shape), mesh)
    for dim, axis in enumerate(spec):
        if axis == "tp":
            n = leaf.shape[dim] // mesh.tp
            leaf = leaf.narrow(dim, mesh.tp_rank * n, n)
    return leaf


def _tp_split(mesh: Mesh) -> bool:
    """Whether the tp collectives run: over a tp group of more than one rank.
    At tp 1 (no process group, or a world of one) each is the identity and
    issues no call (a 1-rank NCCL all-reduce computes nothing and still
    takes stream time)."""
    return mesh.tp > 1 and mesh.tp_group is not None


def tp_all_reduce(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``x`` over the tp group, in place (``x`` itself at tp 1)."""
    if _tp_split(mesh):
        dist.all_reduce(x, group=mesh.tp_group)
    return x


def tp_all_gather(x: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """The tp ranks' ``x`` concatenated along ``dim`` in tp order (every rank
    gets the same bytes: a gather only copies; ``x`` itself at tp 1)."""
    if not _tp_split(mesh):
        return x
    dim = dim % x.dim()
    out = torch.empty((mesh.tp * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=mesh.tp_group)
    return out.view(mesh.tp, *x.shape).movedim(0, dim).flatten(dim, dim + 1)


class _CopyToTP(torch.autograd.Function):
    """Megatron's ``f``: the identity forward, the gradient summed over the
    tp group backward (each tp rank's column-split product gives its part)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return tp_all_reduce(g.clone(memory_format=torch.contiguous_format), ctx.mesh), None


class _ReduceFromTP(torch.autograd.Function):
    """Megatron's ``g``: the tp ranks' partial sums summed forward, the
    gradient passed through backward (every rank holds the whole of it)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return tp_all_reduce(x.clone(memory_format=torch.contiguous_format), mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` entering a column-split product (or a vocabulary slice): the
    identity, whose backward all-reduces the gradient over the tp group
    (``x`` itself at tp 1)."""
    return _CopyToTP.apply(x, mesh) if _tp_split(mesh) else x


def reduce_from_tp(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum over the tp group of a row-split product's partial ``x``,
    whose backward passes the gradient through (``x`` itself at tp 1)."""
    return _ReduceFromTP.apply(x, mesh) if _tp_split(mesh) else x


class TensorParallel:
    """What the model's passes need of a tensor-parallel layout
    (``param_shardings``): which sub-layers are split (``attn``: ``wq``/``wk``/
    ``wv`` by columns and ``wo`` by rows; ``mlp``: ``w_gate``/``w_up`` and
    ``w_down``), whether the embedding rows are a vocabulary slice
    (``embed``: a masked lookup and a sum) and whether the output projection
    is (``head``: the logits all-gathered when serving, the vocab-parallel
    cross-entropy when training).

    ``train`` picks the collectives: the autograd ops ``copy_to_tp`` before a
    split sub-layer (``enter``) and ``reduce_from_tp`` after it (``reduce``),
    or, serving, no autograd (``enter`` the identity, ``reduce`` an in-place
    all-reduce)."""

    def __init__(self, mesh: Mesh, specs: Any, train: bool = False):
        self.mesh, self.train = mesh, train
        layers = specs["layers"]
        self.attn = "tp" in tuple(layers["wo"])
        self.mlp = "tp" in tuple(layers["w_down"])
        self.embed = "tp" in tuple(specs["embed"])
        self.head = "tp" in tuple(specs.get("lm_head", specs["embed"]))

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return copy_to_tp(x, self.mesh) if self.train else x

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return reduce_from_tp(x, self.mesh) if self.train else tp_all_reduce(x, self.mesh)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return tp_all_gather(x, -1, self.mesh)


def shard_dim(spec: Spec, mesh_axis: str = "dp") -> int | None:
    """The dimension ``mesh_axis`` shards in ``spec`` (alone or co-sharded
    with the other axis), or None."""
    for i, axis in enumerate(spec):
        if axis == mesh_axis or (isinstance(axis, tuple) and mesh_axis in axis):
            return i
    return None


@dataclass(frozen=True)
class StateLayout:
    """Where the training state lives across the dp x tp ranks, per leaf
    (trees keyed as the parameters):

    - ``specs``: the tp compute layout (``param_shardings``), and ``tp`` its
      tp-sharded dimension (None: whole on every tp rank, and at tp 1);
      ``local``: the shape of a rank's tp slice, ``shapes`` the full shape;
    - ``params`` / ``moments``: the dp-sharded dimension of the resident
      parameter and of its moments within the tp slice (None: whole on every
      rank of the dp column). A dimension both shard (``("tp", "dp")``) is
      cut tp-major: the tp slice, then the dp slice of it."""

    mesh: Mesh
    params: Any
    moments: Any
    shapes: Any
    tp: Any
    local: Any
    specs: Any

    @classmethod
    def build(cls, mesh: Mesh, shapes: Any, *, num_kv_heads: int, zero1: bool, fsdp: bool) -> "StateLayout":
        """``num_kv_heads`` places attention at tp > 1 (``param_shardings``)."""
        heads = {"num_kv_heads": num_kv_heads}
        specs = param_shardings(mesh, shapes, **heads)
        dims = lambda tree: map_trees(shard_dim, tree)  # noqa: E731
        return cls(mesh, dims(param_shardings(mesh, shapes, fsdp=fsdp, **heads)),
                   dims(opt_state_shardings(mesh, shapes, zero1=zero1 or fsdp, **heads)["mu"]), shapes,
                   map_trees(lambda spec: shard_dim(spec, "tp") if mesh.tp > 1 else None, specs),
                   map_trees(lambda spec, leaf: tp_local_shape(_shape(leaf), spec, mesh), specs, shapes), specs)

    def tensor_parallel(self) -> "TensorParallel | None":
        """The training passes' ``TensorParallel``: None without a tp group
        (no process group, or a pure dp world of several ranks), where
        nothing is split. In a world of one its tp collectives are
        identities, so its passes give the mesh-less passes' bits."""
        return TensorParallel(self.mesh, self.specs, train=True) if self.mesh.tp_group is not None else None

    def tp_slices(self, tree: Any) -> Any:
        """This rank's tp slice of each whole leaf of ``tree``: a contiguous
        copy, so the whole leaf can be dropped (the leaf itself at tp 1)."""
        if self.mesh.tp == 1:
            return tree
        return map_trees(lambda t, spec: tp_shard(t, spec, self.mesh).clone(memory_format=torch.contiguous_format),
                         tree, self.specs)

    def offsets(self, dims: Any) -> Any:
        """Per leaf, where this rank's piece (its tp slice, cut along
        ``dims``, a dp-dims tree) starts in the whole leaf: a start per
        dimension, or None for the whole leaf."""
        mesh = self.mesh

        def starts(dim, tdim, local):
            if dim is None and tdim is None:
                return None
            out = [0] * len(local)
            if tdim is not None:
                out[tdim] += mesh.tp_rank * local[tdim]
            if dim is not None:
                out[dim] += mesh.dp_rank * (local[dim] // mesh.dp)
            return tuple(out)

        return map_trees(starts, dims, self.tp, self.local)

    def fsdp_shards(self) -> dict[str, Any] | None:
        """The gathers of the FSDP forward (``models/llama3.py``): a
        ``LeafShard`` per top-level leaf, a ``LayerShard`` per stacked one;
        None when no resident parameter is sharded."""
        if all(d is None for d in _leaves(self.params)):
            return None
        out = {k: LeafShard(d, self.mesh) for k, d in self.params.items() if k != "layers"}
        out["layers"] = {k: LayerShard(d, self.mesh, self.local["layers"][k])
                         for k, d in self.params["layers"].items()}
        return out


def _leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _leaves(tree[key])]
    return [tree]


# --- placement and collectives over the dp column --------------------------------------------------


def shard(t: torch.Tensor, dim: int | None, mesh: Mesh) -> torch.Tensor:
    """This rank's dp slice of ``t`` along ``dim`` (a copy, so the whole
    tensor can be dropped), or ``t`` when ``dim`` is None."""
    if dim is None:
        return t
    n = t.shape[dim] // mesh.dp
    return t.narrow(dim, mesh.dp_rank * n, n).clone(memory_format=torch.contiguous_format)


def gather(local: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """The tensor whole over the dp column from each rank's slice along
    ``dim`` (an all-gather; every rank of the column joins), contiguous."""
    src = local.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] * mesh.dp, *src.shape[1:]), dtype=src.dtype, device=src.device)
    dist.all_gather_into_tensor(out, src, group=mesh.dp_group)
    return out.movedim(0, dim).contiguous() if dim else out


def reduce_scatter(full: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """This rank's slice along ``dim`` of the sum of the dp column's ``full``
    (a reduce-scatter; every rank of the column joins), contiguous."""
    src = full.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // mesh.dp, *src.shape[1:]), dtype=src.dtype, device=src.device)
    dist.reduce_scatter_tensor(out, src, group=mesh.dp_group)
    return out.movedim(0, dim).contiguous() if dim else out


def shard_params(mesh: Mesh, params: Any, dims: Any, device: torch.device | str | None = None) -> Any:
    """Each parameter's dp slice for this rank (``dims``: the layout's
    ``params`` tree), moved to ``device`` leaf by leaf."""
    return map_trees(lambda t, d: shard(t, d, mesh).to(device if device is not None else t.device), params, dims)


def full_host_copy(tree: Any, dims: Any, mesh: Mesh, tp_dims: Any = None) -> Any:
    """The whole leaves of a dp x tp-sharded tree on rank 0, None on the
    other ranks: a collective every rank joins (the port of the JAX
    ``full_host_copy``, used by the checkpoint save, where rank 0 writes). A
    leaf is gathered over its dp column along ``dims``, then over its tp
    block along ``tp_dims`` (None: not tp-sharded); a whole one is returned
    as it is. The leaves stay on the device; the writer copies each to the
    host as it reaches it."""
    out = map_trees(lambda t, d: t if d is None else gather(t, d, mesh), tree, dims)
    if tp_dims is not None:
        out = map_trees(lambda t, d: t if d is None else tp_all_gather(t, d, mesh), out, tp_dims)
    return out if mesh.rank == 0 else None


class LeafShard:
    """A top-level leaf (embedding, final norm, output head) in the FSDP
    forward: made whole over the dp column by an all-gather where it is
    consumed, its gradient reduce-scattered back to this rank's slice."""

    def __init__(self, dim: int | None, mesh: Mesh):
        self.dim, self.mesh = dim, mesh

    def full(self, local: torch.Tensor) -> torch.Tensor:
        return local if self.dim is None else gather(local, self.dim, self.mesh)

    def reduce(self, grad: torch.Tensor) -> torch.Tensor:
        return grad if self.dim is None else reduce_scatter(grad, self.dim, self.mesh)


class LayerShard:
    """A layer-stacked ``[L, ...]`` leaf (a rank's tp slice of it) in the
    FSDP forward: layer ``l``'s weight is made whole over the dp column where
    the layer consumes it, and its gradient goes back to the rank that holds
    it.

    - sharded along L (dim 0): dp index ``d`` holds layers ``[d L/dp, (d+1) L/dp)``;
      the owner broadcasts the layer, and the gradient is reduced to it;
    - sharded along another dim: every rank holds a slice of every layer; the
      layer is all-gathered and its gradient reduce-scattered;
    - whole (dim None): the layer is this rank's row; its gradient stays here
      (the step all-reduces it with the other whole leaves).
    """

    def __init__(self, dim: int | None, mesh: Mesh, shape: tuple[int, ...]):
        self.dim, self.mesh = dim, mesh  # shape: the leaf's tp slice
        self.per = shape[0] // mesh.dp  # layers a rank holds when sharded along L
        self.layer_shape = tuple(shape[1:])

    def pieces(self, local: torch.Tensor) -> list[torch.Tensor | None]:
        """Per layer, this rank's piece of the layer (None where another rank
        holds all of it). One unbind of the local stack, so that its backward
        stacks the layers' gradients in one pass."""
        rows = local.unbind(0)
        if self.dim != 0:
            return list(rows)
        self._like = {"dtype": local.dtype, "device": local.device}
        first = self.mesh.dp_rank * self.per
        return [rows[l - first] if first <= l < first + self.per else None for l in range(self.per * self.mesh.dp)]

    def full(self, piece: torch.Tensor | None, l: int) -> torch.Tensor:
        if self.dim is None:
            return piece
        if self.dim != 0:
            return gather(piece, self.dim - 1, self.mesh)
        out = piece.clone() if piece is not None else torch.empty(self.layer_shape, **self._like)
        dist.broadcast(out, self.mesh.dp_peer(l // self.per), group=self.mesh.dp_group)
        return out

    def reduce(self, grad: torch.Tensor, l: int) -> torch.Tensor | None:
        if self.dim is None:
            return grad
        if self.dim != 0:
            return reduce_scatter(grad, self.dim - 1, self.mesh)
        owner = l // self.per
        grad = grad.contiguous()
        dist.reduce(grad, self.mesh.dp_peer(owner), group=self.mesh.dp_group)
        return grad if owner == self.mesh.dp_rank else None
