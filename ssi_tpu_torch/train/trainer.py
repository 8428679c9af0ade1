"""Host-side Trainer: the port of ``ssi_tpu/train/trainer.py``, a thin stateful
loop around ``train/step.py`` on one CUDA card (or the CPU, when asked).

- All device state lives in one tree ``{params, opt_state, step}``, updated in
  place by a ``train_step`` that consumes a whole gradient-accumulation window
  ``[accum, batch, seq]`` per call.
- Checkpoint/resume keeps the schema-v1 contract: ``step_N/`` HF dirs plus
  the versioned training state in the JAX package's msgpack bytes (either
  package resumes the other's); resume = epoch derivation + micro-batch skip
  + host RNG restore.
- Training across ranks (``torchrun --nproc_per_node N -m
  ssi_tpu_torch.cli.train_sft ...``; one process and one device a rank, a
  JAX device's counterpart): ``parallel.distributed`` brings up the process
  group (NCCL on CUDA, gloo on the CPU) and a world of ``dp * tp`` ranks is
  the JAX mesh ``(dp, tp)``: rank ``r`` holds tp index ``r % tp`` and dp
  index ``r // tp``. ``batch_size`` is per dp column and the sampler strides
  by dp index (the tp ranks of a column read the same rows), so the run
  trains as the JAX package's one-process ``(dp, tp)`` mesh at ``dp`` times
  the batch. ``parallel.tp`` splits the heads, the MLP and the vocabulary
  (Megatron's layout, ``parallel/__init__.py``); ``parallel.zero1`` shards
  the AdamW moments over dp, ``parallel.fsdp`` the resident parameters
  too, and ``sharded_optimizer_state`` has every rank write its own moment
  slices (``checkpoint/sharded_io.py``). The attention is chosen by device
  (the flash kernels on CUDA), so ``attn_impl`` other than ``auto`` raises.
- The ``device`` key (default ``cuda``) places the run; with no card visible
  the default raises, and ``+device=cpu`` runs on the CPU (the tests).
- ``profiler: {start_step, num_steps, dir}`` traces a window of optimizer
  steps with ``torch.profiler`` and writes a Chrome trace to ``dir``.

Setup/teardown protocol is the JAX package's: ``Trainer(cfg).setup(); .train(); .cleanup()``.
"""

from __future__ import annotations

from collections import defaultdict
import copy
import itertools
import logging
import os
from pathlib import Path
import sys
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ssi_tpu_torch import __version__
from ssi_tpu_torch.checkpoint import (
    Checkpointer,
    resolve_checkpointer_output_dir,
    restore_rng_states,
    save_rng_states,
)
from ssi_tpu_torch.checkpoint import sharded_io
from ssi_tpu_torch.config import compose
from ssi_tpu_torch.constants import CROSS_ENTROPY_IGNORE_IDX, DEBUGGING_TAG, SEED
from ssi_tpu_torch.data import Loader, Sampler, setup_sft_data, setup_text_completion_data
from ssi_tpu_torch.models.configs import get_model_config
from ssi_tpu_torch.parallel import (
    StateLayout,
    full_host_copy,
    initialize_distributed,
    make_mesh,
    map_trees,
    shard,
    shard_params,
    tp_shard,
)
from ssi_tpu_torch.tokenizer import setup_llama3_tokenizer
from ssi_tpu_torch.train.geometry import TrainingGeometry
from ssi_tpu_torch.train.lr_schedule import setup_lr_schedule
from ssi_tpu_torch.train.metric_logging import configure_hydra_logging, configure_job_logging, setup_metric_logger
from ssi_tpu_torch.train.optimizer import AdamWConfig, init_opt_state, tree_map
from ssi_tpu_torch.train.step import compute_dataset_loss, make_eval_step, make_train_step
from ssi_tpu_torch.train.train_utils import (
    get_token_type_ranges,
    resolve_n_dsus,
    resume_training_state,
    validate_resume_hparams,
    validate_train_cfg,
)
from ssi_tpu_torch.utils import resolve_device

__all__ = ["Trainer", "run_training"]

LOGGER = logging.getLogger(__name__)

_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
CONF_DIR = Path(__file__).resolve().parents[2] / "conf"


def refuse_unported(cfg: Any) -> None:
    """Raise on an explicit attention implementation, before any work."""
    attn_impl = cfg.get("attn_impl", "auto")
    if attn_impl != "auto":
        raise ValueError(f"attn_impl={attn_impl!r}: the port chooses the attention by device (the flash kernels "
                         "on CUDA, the plain attention on the CPU); use attn_impl=auto")


def _sorted_tree(tree: Any) -> Any:
    """A nested dict with its keys in sorted order (the JAX package's pytrees
    come back from ``jit`` and ``tree.map`` so, and are written so)."""
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


class Trainer:
    """Stateful trainer for speech-integration experiments on CUDA cards, one a rank.

    Args:
        cfg: composed config (ssi_tpu_torch.config.Config or any duck-typed mapping).
    """

    def __init__(self, cfg: Any) -> None:
        self.cfg = cfg

        # Components — populated by setup()
        self.state: dict[str, Any] | None = None  # {params, opt_state, step} on the device
        self.device: torch.device | None = None
        self.tokenizer = None
        self.checkpointer: Checkpointer | None = None
        self.metric_logger = None
        self.mesh = None
        self.layout: StateLayout | None = None  # where the state lives across the dp x tp ranks
        self.train_step = None
        self.eval_step = None
        self.lr_schedule = None

        # Data
        self.data_train: Loader | None = None
        self.sampler_train: Sampler | None = None
        self.data_dev: Loader | None = None
        self.token_type_ranges: dict[str, tuple[int, int]] | None = None

        # Geometry
        self.geometry: TrainingGeometry | None = None
        self.world_size: int = 1
        self.rank: int = 0
        self.distributed = False  # a process group is up (at any world size)

        # Training counters (host mirrors of device state)
        self.global_step: int = 0
        # Accumulation windows consumed, INCLUDING zero-token windows that apply no
        # optimizer update: the resume data position derives from this, not from
        # global_step, so skipped windows cannot desynchronize step-to-data mapping.
        self.consumed_windows: int = 0
        self.consumed_samples: int = 0
        self.tokens_train_total: int = 0
        self.token_type_counts_total: defaultdict[str, int] = defaultdict(int)
        self.wall_clock_offset: float = 0.0

        # Timing
        self.t_train_start: float = 0.0
        self.t_step_start: float = 0.0
        self._grad_norm: float | None = None

        # Optional loss log for equivalence testing (ref: ssi/trainer.py:193)
        self._loss_log: list[float] | None = None

        # Async checkpoint write (at most one in flight)
        self._save_executor = None
        self._save_future = None
        # seconds and bytes of the last checkpoint write: model and training state
        self.last_save_stats: dict[str, float] = {}

        # torch.profiler window: the running profiler, then its trace and host wall
        self._profiler = None
        self.profile_trace: Path | None = None
        self.profile_wall_s: float | None = None

    # === Setup ===

    def setup(self) -> "Trainer":
        validate_train_cfg(self.cfg)
        refuse_unported(self.cfg)
        self.device = resolve_device(self.cfg)
        self._set_host_seed()
        self.dtype = _DTYPES[self.cfg.dtype]
        # the process group comes up before any device or rank query
        initialize_distributed(self.cfg.get("parallel"), self.device)
        self.distributed = dist.is_initialized()
        if self.distributed:
            self.world_size, self.rank = dist.get_world_size(), dist.get_rank()
            if self.device.type == "cuda":
                self.device = torch.device("cuda", torch.cuda.current_device())

        self._setup_mesh()
        self._setup_logging()
        self._setup_model()
        self._setup_tokenizer()
        self._extract_resume_state()
        self._setup_optimizer()
        self._setup_data()
        self.geometry = TrainingGeometry.from_config(self.cfg, self.data_train, self.mesh.dp)
        self._finalize_resume()
        self._build_steps()
        self._resume_rng_state = self._resume_state.pop("rng_state", None) if self._resume_state else None
        self._resume_state = None
        return self

    def _set_host_seed(self) -> None:
        """Seed host RNGs (python + numpy). Data-order randomness is independently
        keyed per sample/epoch, so this guards only incidental host randomness
        (ref: torchtune training.set_seed at ssi/trainer.py:204)."""
        import random

        random.seed(SEED)
        np.random.seed(SEED % (2**32))

    def _setup_mesh(self) -> None:
        pcfg = self.cfg.get("parallel")
        dp = pcfg.get("dp") if pcfg is not None else None
        tp = int(pcfg.get("tp", 1)) if pcfg is not None else 1
        self._fsdp = bool(pcfg.get("fsdp", False)) if pcfg is not None else False
        # fsdp shards params AND moments over dp (ZeRO-3 superset of ZeRO-1)
        self._zero1 = self._fsdp or (bool(pcfg.get("zero1", False)) if pcfg is not None else False)
        self.mesh = make_mesh(dp=dp, tp=tp, world_size=self.world_size, rank=self.rank)
        if self.mesh.dp * self.mesh.tp != self.world_size:
            raise ValueError(f"The mesh dp={self.mesh.dp} x tp={self.mesh.tp} must cover the {self.world_size} ranks: "
                             "a rank is one device, and every rank trains")
        LOGGER.info(
            f"Device mesh: dp={self.mesh.shape['dp']} tp={self.mesh.shape['tp']}"
            + (" (fsdp: dp-sharded params+moments)" if self._fsdp else " (ZeRO-1 optimizer sharding)" if self._zero1 else "")
        )

    def _setup_logging(self) -> None:
        tags = [__version__, self.cfg.config_name]
        if os.getenv("SLURM_JOB_QOS") == "gpu-debug":
            tags += [DEBUGGING_TAG]
        if self.rank != 0:
            # Non-zero ranks keep an in-memory history but never touch W&B or the
            # shared metrics/log files (rank-0-writes convention).
            from ssi_tpu_torch.train.metric_logging import JsonlLogger

            self.metric_logger = JsonlLogger(log_dir=None)
            if self.cfg.checkpointer.get("output_dir") is None:
                raise ValueError(
                    "Multi-process training requires an explicit checkpointer.output_dir "
                    "(W&B-run-derived resolution is only deterministic on rank 0)."
                )
            return
        self.metric_logger = setup_metric_logger(self.cfg.get("wandb"), tags=tags)
        if self.cfg.checkpointer.get("output_dir") is None:
            if self.world_size > 1:
                raise ValueError(
                    "Multi-process training requires an explicit checkpointer.output_dir "
                    "(W&B-run-derived resolution is only deterministic on rank 0)."
                )
            self.cfg.checkpointer.output_dir = str(resolve_checkpointer_output_dir(self.cfg, self.metric_logger))
            LOGGER.info(f"No checkpointer output dir provided. Resolved to: {self.cfg.checkpointer.output_dir}")
        if hasattr(self.metric_logger, "set_log_dir"):
            self.metric_logger.set_log_dir(self.cfg.checkpointer.output_dir)
        configure_job_logging(self.cfg, self.cfg.checkpointer.output_dir, job_name=str(self.cfg.config_name))

    def _setup_model(self) -> None:
        self._llama_config = copy.deepcopy(get_model_config(self.cfg.get("model_config", "llama3_2_1b")))
        self._llama_config.update_from_speech_cfg(self.cfg.speech)
        ckpt_cfg = {k: v for k, v in self.cfg.checkpointer.items()}
        self.checkpointer = Checkpointer(**ckpt_cfg, model_expectations=self._llama_config.checkpoint_expectations)
        sliced = self.mesh.tp > 1 or (self._fsdp and self.mesh.dp > 1)
        # a tp or FSDP rank loads on the host and keeps only its slices on the device
        params = self.checkpointer.load_params(self._llama_config, dtype=self.dtype,
                                               device="cpu" if sliced else self.device)
        shapes = tree_map(lambda t: tuple(t.shape), params)
        self.layout = StateLayout.build(self.mesh, shapes, zero1=self._zero1, fsdp=self._fsdp,
                                        num_kv_heads=self._llama_config.num_kv_heads)
        params = shard_params(self.mesh, self.layout.tp_slices(params), self.layout.params, self.device)
        self.state = {"params": params, "opt_state": None, "step": 0}

    def _setup_tokenizer(self) -> None:
        tok_cfg = {k: v for k, v in self.cfg.tokenizer.items()}
        self.tokenizer, _special_tokens = setup_llama3_tokenizer(**tok_cfg)
        self.token_type_ranges = get_token_type_ranges(llama_config=self._llama_config)

    def _extract_resume_state(self) -> None:
        self._resume_state: dict[str, Any] | None = None
        training_state = self.checkpointer.load_training_state()
        if training_state is not None:
            self._resume_state = resume_training_state(training_state)
            self.global_step = int(self._resume_state["global_step"])
            self.consumed_samples = int(self._resume_state["consumed_samples"])

    def _setup_optimizer(self) -> None:
        self.opt_cfg = AdamWConfig.from_cfg(self.cfg.optimizer)
        self.lr_schedule = setup_lr_schedule(self.cfg, num_training_steps=self.cfg.max_steps)
        moments_like = self._moment_slices()
        if self._resume_state is None:
            self.state["opt_state"] = init_opt_state(moments_like, self.opt_cfg)
            return
        host_opt = self._resume_state["optimizer_state"]
        state_path = self.checkpointer.training_state_checkpoint
        sharded_io.refuse_orbax_marker(host_opt, state_path)
        if sharded_io.is_marker(host_opt):
            # every rank reads its own slices, re-sharded to this run's dp x tp
            empty = init_opt_state(moments_like, self.opt_cfg)
            self.state["opt_state"] = sharded_io.restore_opt_state(host_opt, Path(state_path).parent, empty,
                                                                   self.layout)
            self.state["step"] = self.global_step
            return

        def place(saved: Any, dim: int | None, shape: tuple, spec: tuple) -> torch.Tensor:
            # a whole state leaf, sliced to this rank's part of the moment layout
            t = saved if isinstance(saved, torch.Tensor) else torch.from_numpy(np.asarray(saved))
            if tuple(t.shape) != tuple(shape):
                raise ValueError(f"optimizer state leaf of shape {tuple(t.shape)} for a parameter of {tuple(shape)}")
            return shard(tp_shard(t, spec, self.mesh), dim, self.mesh).to(self.device).contiguous()

        def restore(saved: dict, like: dict, dims: dict, shapes: dict, specs: dict) -> dict:
            if set(saved) != set(like):
                raise ValueError(f"optimizer state keys {sorted(saved)} do not match the parameters' {sorted(like)}")
            return {k: restore(saved[k], v, dims[k], shapes[k], specs[k]) if isinstance(v, dict)
                    else place(saved[k], dims[k], shapes[k], specs[k]) for k, v in like.items()}

        layout = self.layout
        self.state["opt_state"] = {
            "mu": restore(host_opt["mu"], moments_like, layout.moments, layout.shapes, layout.specs),
            "nu": restore(host_opt["nu"], moments_like, layout.moments, layout.shapes, layout.specs),
            "count": int(np.asarray(host_opt["count"])),
        }
        self.state["step"] = self.global_step

    def _moment_slices(self) -> Any:
        """Tensors of this rank's moment shapes on the device (views of the
        parameters: a ZeRO-1 rank's moments cover a dp slice of its tp slice)."""

        def view(p: torch.Tensor, pd: int | None, md: int | None) -> torch.Tensor:
            if pd is not None or md is None:
                return p
            n = p.shape[md] // self.mesh.dp
            return p.narrow(md, self.mesh.dp_rank * n, n)

        return map_trees(view, self.state["params"], self.layout.params, self.layout.moments)

    def _setup_data(self) -> None:
        # one sampler shard a dp column: its tp ranks read the same rows
        shards = {"num_replicas": self.mesh.dp, "rank": self.mesh.dp_rank}
        if self.cfg.config_name == "sft":
            self.data_train, self.sampler_train = setup_sft_data(self.cfg.data.train, self.tokenizer, **shards)
            self.data_dev, _ = setup_sft_data(self.cfg.data.dev, self.tokenizer, **shards)
        elif self.cfg.config_name == "cpt":
            self.data_train, self.sampler_train = setup_text_completion_data(self.cfg.data.train, self.tokenizer,
                                                                             **shards)
            self.data_dev, _ = setup_text_completion_data(self.cfg.data.dev, self.tokenizer, **shards)
        else:
            raise NotImplementedError(f"Unsupported config_name: {self.cfg.config_name}")

    def _finalize_resume(self) -> None:
        if self._resume_state is None:
            return
        cm = self._resume_state["cumulative_metrics"]
        # Older states without the counter: every window applied, so it equals global_step.
        self.consumed_windows = int(cm.get("consumed_windows", self.global_step))
        self.tokens_train_total = int(cm["tokens_train_total"])
        for k, v in cm["token_type_counts"].items():
            self.token_type_counts_total[k] = int(v)
        self.wall_clock_offset = float(cm["wall_clock_seconds"])
        validate_resume_hparams(
            ckpt_hparams=self._resume_state["training_hparams"],
            current_hparams=self._current_hparams(),
            force_resume=bool(self.cfg.get("force_resume", False)),
        )

    def _current_hparams(self) -> dict[str, Any]:
        return {
            "batch_size": self.geometry.batch_size,
            "gradient_accumulation_steps": self.cfg.gradient_accumulation_steps,
            "world_size": self.mesh.dp,  # the data-parallel replicas, each reading batch_size rows
            "steps_per_epoch": self.geometry.steps_per_epoch,
        }

    def _build_steps(self) -> None:
        # the CPU's chunked cross-entropy takes loss_chunk_size; the CUDA kernels tile themselves
        chunk_size = int(self.cfg.get("loss_chunk_size", 1024))
        accum_dtype = _DTYPES[self.cfg.get("grad_accum_dtype", "fp32")]
        layout = self.layout if self.distributed else None  # collectives need a process group
        self.train_step = make_train_step(
            self._llama_config,
            self.opt_cfg,
            self.lr_schedule,
            clip_grad_norm=self.cfg.get("clip_grad_norm"),
            token_type_ranges=self.token_type_ranges,
            pad_id=self.tokenizer.pad_id,
            remat=self.cfg.get("remat", True),  # bool or a REMAT_POLICIES name
            chunk_size=chunk_size,
            grad_accum_dtype=accum_dtype,
            layout=layout,
        )
        self.eval_step = make_eval_step(self._llama_config, chunk_size=chunk_size, layout=layout)

    # === Training ===

    def train(self) -> None:
        self.t_train_start = time.perf_counter()

        epochs_run = self.consumed_windows // self.geometry.steps_per_epoch
        batches_to_skip = (self.consumed_windows % self.geometry.steps_per_epoch) * self.cfg.gradient_accumulation_steps

        if getattr(self, "_resume_rng_state", None) is not None:
            restore_rng_states(self._resume_rng_state)
            LOGGER.info("Restored framework RNG states from checkpoint.")
            self._resume_rng_state = None

        from ssi_tpu_torch.config import to_yaml

        LOGGER.info(to_yaml(self.cfg, resolve=True))
        if self.rank == 0:  # one writer of the shared config snapshot
            self.metric_logger.log_config(self.cfg, checkpoint_dir=self.cfg.checkpointer.output_dir)

        for epoch in range(epochs_run, self.geometry.n_epochs):
            self._train_epoch(epoch, batches_to_skip if epoch == epochs_run else 0)
            if self.global_step >= self.cfg.max_steps:
                self._save_final_checkpoint()
                LOGGER.info("Training completed.")
                return
        self._save_final_checkpoint()

    def _save_final_checkpoint(self) -> None:
        """Save the run's end state when max_steps isn't a save_steps multiple —
        otherwise up to save_steps-1 steps of progress (the run's end product)
        would silently be discarded."""
        if self.global_step != 0 and self.global_step % self.cfg.save_steps != 0:
            self.save_checkpoint()
            LOGGER.info(f"Final checkpoint saved at step {self.global_step}")

    def _train_epoch(self, epoch: int, batches_to_skip: int = 0) -> None:
        if self.sampler_train is not None:
            self.sampler_train.set_epoch(epoch)
        if hasattr(self.data_train.dataset, "set_epoch"):
            self.data_train.dataset.set_epoch(epoch)

        if batches_to_skip > 0:
            LOGGER.info(f"Resuming: skipping {batches_to_skip} batches in epoch {epoch}")
        data_iter = itertools.islice(enumerate(self.data_train), batches_to_skip, self.geometry.usable_batches)

        # overlap_io keeps ONE dispatched window in flight: the host reads and
        # stacks window N+1 while the device runs window N's optimizer update
        # (the step syncs on its token count before AdamW, and N's metrics reach
        # the host behind an event of their own), and window N is processed only
        # after N+1 is dispatched. Metric/counter/checkpoint processing stays in
        # strict window order, so every logged value is identical to the
        # synchronous loop. duration_step times each window in both loops: from
        # the moment the host starts reading its micro-batches to its
        # dispatch's return, plus any wait for its own metrics (its update). A
        # window kept in flight waits for none: its update runs under the next
        # window's read, and what that read does not hide falls in the next
        # window's duration. Processing (logging, dev loss, save) falls in none.
        overlap = bool(self.cfg.get("overlap_io", True))
        accum = self.cfg.gradient_accumulation_steps
        window: list[dict[str, Any]] = []
        pending: dict[str, Any] | None = None
        self.t_step_start = time.perf_counter()
        for i, batch in data_iter:
            window.append(batch)
            if len(window) != accum:
                continue
            if pending is not None and self._pending_needs_state():
                # the in-flight window's processing reads post-step device state
                # (eval / checkpoint / final step) — the next dispatch would
                # update that state in place, so complete it first
                self._process_window(pending)
                pending = None
                if self.global_step >= self.cfg.max_steps:
                    return
            nxt = self._dispatch_window(epoch, i, window, in_flight=int(pending is not None))
            window = []
            if overlap:
                nxt["t_done"] = self.t_step_start = time.perf_counter()
            if pending is not None:
                self._process_window(pending)
                pending = None
            if overlap:
                pending = nxt
            else:
                self._process_window(nxt)
            if self.global_step >= self.cfg.max_steps:
                break
        if pending is not None:
            self._process_window(pending)

    def _stack_window(self, window: list[dict[str, Any]]) -> dict[str, np.ndarray]:
        """Stack accumulation-window micro-batches to [A, B, S] (pad to window max)."""
        s_max = max(b["tokens"].shape[1] for b in window)
        pad_id = self.tokenizer.pad_id

        def pad_to(arr: np.ndarray, value: int) -> np.ndarray:
            if arr.shape[1] == s_max:
                return arr
            out = np.full((arr.shape[0], s_max), value, dtype=arr.dtype)
            out[:, : arr.shape[1]] = arr
            return out

        pad_values = {"tokens": pad_id, "labels": CROSS_ENTROPY_IGNORE_IDX, "segment_ids": 0, "positions": 0}
        keys = ["tokens", "labels"] + [k for k in ("segment_ids", "positions") if k in window[0]]
        return {k: np.stack([pad_to(b[k], pad_values[k]) for b in window]) for k in keys}

    def _maybe_profile(self, dispatched_step: int) -> None:
        """Opt-in ``torch.profiler`` trace window. Config: ``profiler: {start_step,
        num_steps, dir}``; the Chrome trace goes to ``dir`` (default
        ``<output_dir>/profile``), its path to ``self.profile_trace``.

        ``dispatched_step`` is the step count at the moment of dispatch INCLUDING
        any window still in flight under overlap_io, so the trace covers the same
        optimizer steps whether or not the input pipeline is overlapped."""
        pcfg = self.cfg.get("profiler")
        if pcfg is None:
            return
        start = int(pcfg.get("start_step", 5))
        num = int(pcfg.get("num_steps", 3))
        if dispatched_step == start and self._profiler is None and self.profile_trace is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._trace_dir = Path(pcfg.get("dir") or Path(self.cfg.checkpointer.output_dir) / "profile")
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.start()
            self._profile_t0 = time.perf_counter()
            LOGGER.info(f"torch.profiler trace started -> {self._trace_dir}")
        elif self._profiler is not None and dispatched_step >= start + num:
            self._stop_profiler()

    def _stop_profiler(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.profile_wall_s = time.perf_counter() - self._profile_t0
        self._profiler.stop()
        self._trace_dir.mkdir(parents=True, exist_ok=True)
        self.profile_trace = self._trace_dir / f"trace_rank{self.rank}.json"
        self._profiler.export_chrome_trace(str(self.profile_trace))
        self._profiler = None
        LOGGER.info(f"torch.profiler trace stopped -> {self.profile_trace}")

    def _pending_needs_state(self) -> bool:
        """True when the in-flight window's processing may read the post-step
        device state — dev-set eval, checkpoint save, or the run's final step —
        so it must complete BEFORE the next dispatch updates that state."""
        ps = self.global_step + 1  # the step the pending window becomes (if applied)
        return (
            ps % self.cfg.eval_steps == 0
            or ps % self.cfg.save_steps == 0
            or ps >= self.cfg.max_steps
        )

    def _dispatch_window(
        self, epoch: int, iter_idx: int, window: list[dict[str, Any]], in_flight: int = 0
    ) -> dict[str, Any]:
        """Stack + upload one accumulation window and run the step. Returns the
        record ``_process_window`` consumes. ``in_flight`` counts
        dispatched-but-unprocessed windows (0 or 1 under overlap_io) so
        step-indexed triggers like the profiler see the would-be step of THIS
        window."""
        self._maybe_profile(self.global_step + in_flight)
        stacked = self._stack_window(window)
        put = {k: torch.from_numpy(v).to(self.device) for k, v in stacked.items()}
        self.state, metrics = self.train_step(
            self.state, put["tokens"], put["labels"], put.get("segment_ids"), put.get("positions")
        )
        metrics, ready = self._metrics_to_host(metrics)
        return {
            "epoch": epoch,
            "iter_idx": iter_idx,
            "metrics": metrics,
            "ready": ready,
            "max_seq_len": int(stacked["tokens"].shape[-1]),
            "t_start": self.t_step_start,
        }

    def _optimizer_step(self, epoch: int, iter_idx: int, window: list[dict[str, Any]]) -> None:
        """Synchronous dispatch + process (kept as the unit-test surface)."""
        self._process_window(self._dispatch_window(epoch, iter_idx, window))

    def _metrics_to_host(self, metrics: dict[str, Any]) -> tuple[dict[str, Any], torch.cuda.Event | None]:
        """Copy the step's device metrics to (pinned) host memory behind its
        optimizer update, and return the copies with an event marking their
        arrival: reading them waits for that event alone, where a read of a
        device tensor would wait for everything queued by then (under
        overlap_io, the next window's update too)."""
        if self.device.type != "cuda":
            return metrics, None

        def to_host(x):
            if isinstance(x, dict):
                return {k: to_host(v) for k, v in x.items()}
            return x.to("cpu", non_blocking=True) if x.is_cuda else x

        metrics = to_host(metrics)
        ready = torch.cuda.Event()
        ready.record()
        return metrics, ready

    def _process_window(self, pending: dict[str, Any]) -> None:
        t_entry = time.perf_counter()
        if pending["ready"] is not None:
            pending["ready"].synchronize()
        t_read = time.perf_counter()
        # a window kept in flight ends at its dispatch's return, plus any wait here
        end = pending["t_done"] + (t_read - t_entry) if "t_done" in pending else t_read
        self._apply_window(pending, end - pending["t_start"])
        if "t_done" in pending:
            # an in-flight window: its processing falls in the next window's interval
            self.t_step_start += time.perf_counter() - t_entry
        else:
            self.t_step_start = time.perf_counter()

    def _apply_window(self, pending: dict[str, Any], dur_step: float) -> None:
        epoch, iter_idx = pending["epoch"], pending["iter_idx"]
        metrics = pending["metrics"]

        # The window's metrics, in hand (the one read per optimizer step)
        self.consumed_windows += 1
        loss_sum = float(metrics["loss_sum"])
        num_tokens_step = int(metrics["num_tokens"])
        applied = bool(metrics["applied"])
        self._grad_norm = float(metrics["grad_norm"])
        self._last_lr = float(metrics["lr"])
        if "token_counts" in metrics:
            for tt in sorted(metrics["token_counts"]):  # the JAX step's metrics come back key-sorted
                self.token_type_counts_total[tt] += int(metrics["token_counts"][tt])

        if not applied:
            LOGGER.warning("No non-ignored tokens in accumulation window; skipping optimizer step.")
            return

        self.global_step += 1
        self.consumed_samples += self.cfg.gradient_accumulation_steps * self.geometry.batch_size * self.mesh.dp
        loss_to_log = loss_sum / num_tokens_step
        self.tokens_train_total += num_tokens_step
        self._num_tokens_step = num_tokens_step
        self._max_seq_len_step = pending["max_seq_len"]

        if self._loss_log is not None:
            self._loss_log.append(loss_to_log)

        self._log_metrics(epoch, iter_idx, loss_to_log, dur_step)
        self._maybe_save_checkpoint()

    def _evaluate(self) -> float:
        def put_batch(batch):
            keys = ["tokens", "labels"] + [k for k in ("segment_ids", "positions") if k in batch]
            return tuple(torch.from_numpy(np.asarray(batch[k])).to(self.device) for k in keys)

        return compute_dataset_loss(
            self.eval_step, self.state["params"], self.data_dev, put_batch=put_batch, log_every=10
        )

    def _log_metrics(self, epoch: int, iter_idx: int, loss_to_log: float, dur_step: float) -> None:
        LOGGER.info(
            " | ".join(
                (
                    f"Epoch {epoch + 1:03d}",
                    f"Iteration {iter_idx:0{len(str(self.geometry.batches_per_epoch))}d}"
                    f" / {self.geometry.batches_per_epoch}",
                    f"Global Step {self.global_step}",
                    f"Loss: {loss_to_log:.4f}",
                    f"Tokens (num_tokens_step): {self._num_tokens_step}",
                )
            )
        )

        if self.global_step % self.cfg.eval_steps == 0:
            dev_loss = self._evaluate()
        else:
            dev_loss = None

        if self.global_step % self.cfg.log_interval == 0:
            n_chips = self.mesh.dp * self.mesh.tp
            log_dict = {
                "loss": loss_to_log,
                "lr": self._last_lr,
                "duration_step": dur_step,
                "tokens_per_second_per_gpu": self._num_tokens_step / dur_step / n_chips,
                "tokens_total": self.tokens_train_total,
                "train_clock_time": (self.wall_clock_offset + (time.perf_counter() - self.t_train_start)) / (60**2),
                "max_seq_len_step": self._max_seq_len_step,
                **{f"n_tokens.{tt}": ttcnt for tt, ttcnt in self.token_type_counts_total.items()},
            }
            if self.cfg.get("clip_grad_norm") is not None:
                log_dict.update({"grad_norm": self._grad_norm})
            if dev_loss is not None:
                log_dict.update({"dev_loss": dev_loss})
            self.metric_logger.log_dict(log_dict, step=self.global_step)
        elif dev_loss is not None:
            # eval step that isn't a log-interval step: never discard a computed dev loss
            self.metric_logger.log_dict({"dev_loss": dev_loss}, step=self.global_step)

    def _maybe_save_checkpoint(self) -> None:
        if self.global_step != 0 and self.global_step % self.cfg.save_steps == 0:
            self.save_checkpoint()
            LOGGER.info(f"Checkpoint saved at step {self.global_step}")

    # === Checkpointing ===

    def save_checkpoint(self) -> None:
        """Save HF-format model weights + schema-v1 training state
        (ref: ssi/trainer.py:494-514).

        Synchronous saves write from the device tensors, each copied to the
        host once as the writer reaches it. With ``async_save: true`` the
        parameters and optimizer state are first copied to the host (training
        updates them in place) and the RNG states captured, then serialization
        and disk IO run on a background thread overlapped with training. At
        most one save is in flight; a new save (or cleanup) joins the previous
        one first.

        Across ranks every rank joins the gathers of the sharded leaves (over
        its dp column, then its tp block) and the sharded optimizer save,
        when on, on the training thread; rank 0 alone writes the files and
        prunes.
        """
        self._join_pending_save()
        async_save = bool(self.cfg.get("async_save", False))
        if async_save:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            snapshot = lambda t: t.detach().to("cpu", copy=True)  # noqa: E731
        else:
            snapshot = lambda t: t  # noqa: E731
        step = self.global_step
        opt = self.state["opt_state"]
        sharded_opt = bool(self.cfg.get("sharded_optimizer_state", False))
        layout = self.layout
        params = full_host_copy(self.state["params"], layout.params, self.mesh, layout.tp)
        if sharded_opt:
            # every rank writes its own slices (a collective, so on the training
            # thread); the msgpack holds a directory marker
            host_opt = sharded_io.save_opt_state(opt, layout, Path(self.checkpointer.output_dir), step)
        else:
            mu = full_host_copy(opt["mu"], layout.moments, self.mesh, layout.tp)
            nu = full_host_copy(opt["nu"], layout.moments, self.mesh, layout.tp)
        if self.rank != 0:
            return
        params = tree_map(snapshot, params)
        if not sharded_opt:
            host_opt = _sorted_tree({
                "mu": tree_map(snapshot, mu),
                "nu": tree_map(snapshot, nu),
                # the JAX package's count is a 0-d int32 array
                "count": np.asarray(opt["count"], dtype=np.int32),
            })
        rng_state = save_rng_states()
        kwargs = dict(
            optimizer_state=host_opt,
            lr_scheduler_state={"last_step": step},
            global_step=step,
            seed=SEED,
            training_hparams=self._current_hparams(),
            consumed_samples=self.consumed_samples,
            cumulative_metrics={
                "tokens_train_total": self.tokens_train_total,
                "token_type_counts": dict(self.token_type_counts_total),
                "wall_clock_seconds": self.wall_clock_offset + (time.perf_counter() - self.t_train_start),
                "consumed_windows": self.consumed_windows,
            },
            rng_state=rng_state,
        )

        def write():
            t0 = time.perf_counter()
            step_dir = self.checkpointer.save_model_checkpoint(params, self._llama_config, step)
            t1 = time.perf_counter()
            state_path = self.checkpointer.save_training_state(**kwargs)
            t2 = time.perf_counter()
            self.last_save_stats = {
                "step": step,
                "model_s": t1 - t0,
                "model_bytes": sum(p.stat().st_size for p in step_dir.glob("*.safetensors")),
                "state_s": t2 - t1,
                "state_bytes": state_path.stat().st_size,
            }
            self._prune_checkpoints(keep_step=step)
            if sharded_opt:
                # only after the state msgpack referencing `step` is on disk
                sharded_io.prune_old_opt_states(Path(self.checkpointer.output_dir), keep_step=step)

        if async_save:
            import concurrent.futures

            if self._save_executor is None:
                self._save_executor = concurrent.futures.ThreadPoolExecutor(max_workers=1)
            self._save_future = self._save_executor.submit(write)
        else:
            write()

    def _join_pending_save(self) -> None:
        if getattr(self, "_save_future", None) is not None:
            self._save_future.result()  # surface exceptions from the background write
            self._save_future = None

    def _prune_checkpoints(self, keep_step: int) -> None:
        """Retention policy: keep only the newest N step dirs (null/absent = keep everything)."""
        keep_n = self.cfg.get("keep_last_n_checkpoints")
        if not keep_n:
            return
        import shutil

        root = Path(self.cfg.checkpointer.output_dir)
        # the dir training loaded from is the source every save copies configs
        # out of — pruning it (e.g. resuming from an older step_N in this same
        # output dir) would crash every subsequent save
        src_dir = Path(self.cfg.checkpointer.checkpoint_dir).resolve()
        step_dirs = []
        for p in root.glob("step_*"):
            try:
                step_dirs.append((int(p.name.removeprefix("step_")), p))
            except ValueError:
                continue
        step_dirs.sort(reverse=True)
        for step_num, p in step_dirs[int(keep_n):]:
            if step_num == keep_step or p.resolve() == src_dir:
                continue
            shutil.rmtree(p, ignore_errors=True)
            LOGGER.info(f"Pruned old checkpoint {p} (keep_last_n_checkpoints={keep_n})")

    # === Cleanup ===

    def cleanup(self) -> None:
        if self._profiler is not None:
            self._stop_profiler()
        self._join_pending_save()
        if getattr(self, "_save_executor", None) is not None:
            self._save_executor.shutdown(wait=True)
            self._save_executor = None
        if self.metric_logger is not None:
            self.metric_logger.close()
        if dist.is_initialized():
            dist.destroy_process_group()


def run_training(config_name: str, argv: list[str]) -> Trainer:
    """The training CLIs (``cli/train_sft.py``, ``cli/train_cpt.py``): compose
    ``conf/<config_name>.yaml`` with the ``key=value`` overrides of ``argv``,
    refuse before any work when the card is missing (unless ``+device=cpu``),
    apply the hydra logging config, resolve ``speech.n_dsus`` from the data
    config, then set up, train and clean up a ``Trainer``, and return it."""
    logging.basicConfig(
        format="[%(asctime)s][%(name)s][%(levelname)s] - %(message)s",
        level=logging.INFO,
        stream=sys.stdout,
    )
    cfg = compose(str(CONF_DIR), config_name, overrides=argv)
    resolve_device(cfg)
    configure_hydra_logging(cfg)
    resolve_n_dsus(cfg)
    trainer = Trainer(cfg)
    trainer.setup()
    trainer.train()
    trainer.cleanup()
    return trainer
