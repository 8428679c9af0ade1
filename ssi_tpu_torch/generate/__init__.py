"""Generation subsystem: batched decode from HF ``step_N/`` checkpoint dirs —
the port's copy of ``ssi_tpu/generate/__init__.py``.

``run_generation(cfg)`` mirrors the reference generate flow: SFT dataset in
inference mode -> the paged engine (``engine: paged``, the default:
continuous batching; the CUDA flash prefill, fused paged decode and, with
``speculate_k > 0``, verify kernels on the card) or the dense engine
(``engine: dense``: fixed batches of ``batch_size``, the last one padded
with copies of its first prompt) -> HF/vLLM-compatible
``generations.jsonl`` consumable unchanged by the WER script. The output
tree, config snapshot, record layout and key order are the JAX package's;
``tests/test_torch_generate.py`` and ``tests/test_torch_dense_engine.py``
hold greedy runs of either engine equal to it line for line.

What the port adds: a ``device`` config key (default ``cuda``; ``+device=cpu``
runs on the CPU, and without a CUDA device the default raises — there is no
fallback) and a seed per batch drawn from ``cfg.seed`` for the engine (greedy
output does not depend on it; sampled output cannot match ``jax.random``).
``quantize_weights: int8`` passes to the engine, as in the JAX package, and
``sampling_params.n > 1`` writes one record per prompt with n entries in
``outputs``. The paged engine runs at its default pipeline depth, 2, as
the JAX one does. ``tensor_parallel: N > 1`` serves the paged engine over a
tp mesh of N ranks (``torchrun --nproc_per_node N``; the CLI joins the
process group): every rank loads only its slices of the checkpoint and
follows rank 0's dispatches, and rank 0 alone writes the output tree. With
the dense engine it raises the JAX package's ``ValueError``.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
import time
from typing import Any

from ssi_tpu_torch.generate.engine import SamplingParams

LOGGER = logging.getLogger(__name__)

__all__ = ["SamplingParams", "run_generation", "resolve_gen_output_dir", "validate_generate_config"]

# the last run's stage timings (seconds) and checkpoint bytes, for callers that report them
last_run_stats: dict[str, float] = {}

_DTYPES = {"bf16": "bfloat16", "fp32": "float32"}


def _serving_mesh(tp: int):
    """The mesh of tensor-parallel serving (``tensor_parallel`` config key):
    dp 1 x tp over a process group of exactly ``tp`` ranks, one device each;
    None for the one-device default. The JAX ``make_mesh`` checks the device
    count; here a rank is a process, so the world size must be ``tp``."""
    if tp <= 1:
        return None
    import torch.distributed as dist

    from ssi_tpu_torch.parallel import make_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != tp:
        raise ValueError(f"tensor_parallel={tp} needs a world of {tp} ranks, one device each (this one has "
                         f"{world}): launch with torchrun --nproc_per_node {tp}")
    return make_mesh(dp=1, tp=tp)


def resolve_gen_output_dir(cfg: Any) -> str:
    """checkpoints/... -> generations/... path convention (ref: scripts/generate.py:34-56)."""
    model_dir = Path(cfg.model).resolve(strict=True)
    experiments_root_dir = Path(cfg.experiments_root_dir).resolve(strict=True)
    if not model_dir.is_relative_to(experiments_root_dir):
        raise ValueError(
            f"Could not resolve null generation output directory. Model {cfg.model} not in "
            f"{cfg.experiments_root_dir}. Specify a generation output directory in the config "
            "or check your model path."
        )
    if "checkpoints" not in model_dir.parts:
        raise ValueError(
            "Could not resolve null generation output directory: expected the model dir to be "
            "under a 'checkpoints' directory (e.g. .../checkpoints/step_2000)."
        )
    parts = list(model_dir.parts)
    parts[len(parts) - 1 - parts[::-1].index("checkpoints")] = "generations"
    gen_output_dir = str(Path(*parts).resolve(strict=False))
    LOGGER.info(f"Resolved null generation output directory to: {gen_output_dir}")
    return gen_output_dir


def validate_generate_config(cfg: Any) -> None:
    from ssi_tpu_torch.config import missing_keys

    missing = missing_keys(cfg)
    if missing:
        raise ValueError(f"Missing keys in config: {missing}")
    n = int(cfg.sampling_params.get("n", 1))
    if n < 1:
        raise ValueError(f"sampling_params.n must be >= 1 (got {n})")
    if n != 1 and str(cfg.get("engine", "paged")) != "paged":
        raise ValueError(
            "sampling_params.n > 1 requires engine=paged (the dense engine decodes one sequence per prompt)"
        )
    engine_kind = str(cfg.get("engine", "paged"))
    if engine_kind not in ("paged", "dense"):
        raise ValueError(f"Unknown engine {engine_kind!r}; expected 'paged' or 'dense'")
    if int(cfg.get("tensor_parallel", 1) or 1) > 1 and engine_kind == "dense":
        raise ValueError(
            "tensor_parallel > 1 requires engine=paged (the dense engine runs "
            "single-device; silently ignoring the mesh would under-use the slice)"
        )
    if str(cfg.get("dtype", "bf16")) not in _DTYPES:
        raise ValueError(f"Unknown dtype {cfg.get('dtype')!r}; expected one of {sorted(_DTYPES)}")


def run_generation(cfg: Any) -> Path:
    """Batched generation over an SFT split; writes generations.jsonl + config
    snapshot. On a follower rank of a tp mesh it loads this rank's slices,
    builds the same engine and follows rank 0, which writes."""
    import shutil
    import tempfile

    import torch

    from ssi_tpu_torch.checkpoint import Checkpointer
    from ssi_tpu_torch.config import to_container, to_yaml
    from ssi_tpu_torch.data.sft import SFTDataset
    from ssi_tpu_torch.models.configs import get_model_config
    from ssi_tpu_torch.tokenizer import setup_llama3_tokenizer
    from ssi_tpu_torch.utils import hash_cfg, resolve_device

    validate_generate_config(cfg)
    device = resolve_device(cfg)
    mesh = _serving_mesh(int(cfg.get("tensor_parallel", 1) or 1))
    # under a mesh tp rank 0 drives the engine and writes; the others follow it
    driver = mesh is None or mesh.tp_rank == 0
    if cfg.gen.get("output_dir") is None:
        cfg.gen.output_dir = resolve_gen_output_dir(cfg)

    tok_cfg = {k: v for k, v in cfg.tokenizer.items()}
    tokenizer, special_tokens = setup_llama3_tokenizer(**tok_cfg)
    special_int2str = {v: k for k, v in special_tokens.items()}
    stop_token_ids = cfg.sampling_params.get("stop_token_ids")
    if stop_token_ids is None:
        stop_token_ids = list(tokenizer.stop_tokens)  # {eos, eom, eot} (ref: scripts/generate.py:87)

    # Normalize the config BEFORE hashing so the cfg-hash subdir matches the snapshot.
    if not cfg.data[cfg.gen.split].dataset.inference:
        cfg.data[cfg.gen.split].dataset.inference = True
        LOGGER.warning("Auto-setting dataset to inference mode.")

    # HF repo ids are owner/name; local data-file types ("json", "csv") have no owner
    gen_dataset_name = cfg.data[cfg.gen.split].dataset.source.split("/")[-1]
    gen_output_dir = Path(cfg.gen.output_dir) / gen_dataset_name / cfg.gen.split
    if cfg.gen.use_cfg_hash_subdir:
        gen_output_dir = gen_output_dir / hash_cfg(cfg)
    if driver:
        gen_output_dir.mkdir(parents=True, exist_ok=False)  # fail early if it already exists

        # job start: hand logging from the framework-phase (hydra_logging) config
        # over to the job's own config, file handler in the generation output dir
        from ssi_tpu_torch.train.metric_logging import configure_job_logging

        configure_job_logging(cfg, gen_output_dir, job_name="generate")

        cfg_yaml = to_yaml(cfg, resolve=True)
        with open(gen_output_dir / cfg.gen.output_config_filename, "x") as f:
            f.write(cfg_yaml)
        LOGGER.info(cfg_yaml)

    # Model load: architecture from registry + speech extension arithmetic
    model_cfg = get_model_config(cfg.get("model_config", "llama3_2_1b")).copy()
    model_cfg.update_from_speech_cfg(cfg.speech)
    # a follower writes nothing under rank 0's output tree (the loader never writes)
    scratch = gen_output_dir / "_ckpt_scratch" if driver else Path(tempfile.mkdtemp(prefix="ssi_follow_ckpt_"))
    checkpointer = Checkpointer(
        checkpoint_dir=cfg.model,
        output_dir=scratch,
        model_expectations=model_cfg.checkpoint_expectations,
    )
    dtype = getattr(torch, _DTYPES[str(cfg.get("dtype", "bf16"))])
    t0 = time.perf_counter()
    params = checkpointer.load_params(model_cfg, dtype=dtype, device=device, mesh=mesh)
    if not driver:
        shutil.rmtree(scratch, ignore_errors=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stats = {"load_s": time.perf_counter() - t0, "load_bytes": float(checkpointer.checkpoint_bytes)}
    LOGGER.info(f"Loaded {stats['load_bytes'] / 1e9:.3f} GB of weights onto {device} in {stats['load_s']:.2f}s")

    dataset_kwargs = to_container(cfg.data[cfg.gen.split].dataset, resolve=True)
    dataset = SFTDataset(model_tokenizer=tokenizer, **dataset_kwargs)

    sp = SamplingParams.from_cfg(cfg.sampling_params, stop_token_ids)

    batch_size = int(cfg.get("batch_size", cfg.get("vllm_batch_size", 8)))
    engine_kind = str(cfg.get("engine", "paged"))

    # Tokenize the whole split ONCE: SFTDataset.__getitem__ re-runs the message
    # transform + tokenizer on every access, so indexing rows again inside the
    # generation loop would double host-side tokenization cost. A follower
    # tokenizes it too: the engine's context size is the longest prompt's.
    t0 = time.perf_counter()
    all_prompts = [dataset[i]["tokens"] for i in range(len(dataset))]
    stats["tokenize_s"] = time.perf_counter() - t0

    if engine_kind == "paged":
        from ssi_tpu_torch.generate.paged_engine import PagedDecodeEngine

        # One continuous-batching stream: n_slots rows advance together and
        # finished rows are refilled from the queue — no partial-batch padding.
        max_prompt = max((len(t) for t in all_prompts), default=0)
        engine = PagedDecodeEngine(
            params, model_cfg, pad_id=tokenizer.pad_id,
            n_slots=batch_size,
            max_context=max_prompt + sp.max_tokens,
            quantize=cfg.get("quantize_weights"),
            speculate_k=int(cfg.get("speculate_k", 0) or 0),
            prefix_caching=bool(cfg.get("prefix_caching", True)),
            prefill_chunk=cfg.get("prefill_chunk"),
            admission_order=str(cfg.get("admission_order", "fifo") or "fifo"),
            mesh=mesh,
        )
        if not driver:
            engine.follow()  # rank 0's dispatches, until it closes the engine
            return gen_output_dir
    else:
        from ssi_tpu_torch.generate.engine import DecodeEngine

        engine = DecodeEngine(params, model_cfg, pad_id=tokenizer.pad_id)
    try:
        _write_records(cfg, engine, engine_kind, all_prompts, sp, tokenizer, special_int2str, stats,
                       gen_output_dir)
    finally:
        if engine_kind == "paged":
            engine.close()  # releases a tp mesh's followers
    # scratch dir is only created by Checkpointer init; remove if empty
    scratch = gen_output_dir / "_ckpt_scratch"
    if scratch.exists() and not any(scratch.iterdir()):
        scratch.rmdir()
    last_run_stats.clear()
    last_run_stats.update(stats)
    LOGGER.info(f"Wrote outputs to {gen_output_dir!s}")
    return gen_output_dir


def _write_records(cfg: Any, engine: Any, engine_kind: str, all_prompts: list, sp: SamplingParams, tokenizer: Any,
                   special_int2str: dict, stats: dict, gen_output_dir: Path) -> None:
    """Run the split through the engine and write ``generations.jsonl``."""
    import numpy as np

    batch_size = int(cfg.get("batch_size", cfg.get("vllm_batch_size", 8)))
    decoding = dict(cfg.tokenizer_decoding.items()) if cfg.get("tokenizer_decoding") is not None else {}
    observability = bool(cfg.get("observability", False))

    n = len(all_prompts)
    request_id = 0
    # one engine seed per engine call, drawn from cfg.seed (the JAX run splits a PRNG key)
    seeds = np.random.default_rng(int(cfg.get("seed", 0)))
    if observability and engine_kind == "paged" and n > 0:
        # Observability promises steady-state decode metrics: run two prompts
        # through the engine once to absorb first-use costs (on the card: the
        # kernel library's first load, cuBLAS handles, the caching allocator);
        # outputs are discarded.
        t0 = time.perf_counter()
        engine.generate_batch(all_prompts[: min(2, n)], sp, seed=int(seeds.integers(2**31)))
        stats["warmup_s"] = time.perf_counter() - t0
        LOGGER.info(f"Warmup pass: {stats['warmup_s']:.1f}s")
    # the paged engine schedules internally: hand it the whole request stream
    step = max(n, 1) if engine_kind == "paged" else batch_size
    stats["generate_s"] = 0.0
    with open(gen_output_dir / cfg.gen.output_filename, "x") as f:
        for start in range(0, n, step):
            prompts = all_prompts[start : min(start + step, n)]
            real = len(prompts)
            if engine_kind == "dense":
                # pad the final partial batch with copies of its first prompt (one batch shape)
                while len(prompts) < batch_size:
                    prompts.append(prompts[0])
            t0 = time.perf_counter()
            outs = engine.generate_batch(prompts, sp, seed=int(seeds.integers(2**31)))
            dt = time.perf_counter() - t0
            stats["generate_s"] += dt
            gen_tokens = sum(len(o["token_ids"]) for o in outs[: real * sp.n])

            for i in range(real):
                # prompt-major / sequence-minor when sampling_params.n > 1 (vLLM:
                # one record, n entries in outputs)
                seq_outs = outs[i * sp.n : (i + 1) * sp.n]
                record = {
                    "request_id": str(request_id),
                    "prompt": tokenizer.decode(list(prompts[i]), **decoding),
                    "prompt_token_ids": list(map(int, prompts[i])),
                    "finished": True,
                    "outputs": [
                        {
                            "index": j,
                            "text": tokenizer.decode(list(out["token_ids"]), **decoding),
                            "token_ids": list(map(int, out["token_ids"])),
                            "cumulative_logprob": out.get("cumulative_logprob"),
                            "logprobs": out.get("logprobs"),
                            "finish_reason": out["finish_reason"],
                            "stop_reason": int(out["stop_reason"]) if out["stop_reason"] is not None else None,
                            "stop_reason_text": special_int2str.get(out["stop_reason"])
                            if out["stop_reason"] is not None else None,
                        }
                        for j, out in enumerate(seq_outs)
                    ],
                }
                if observability:
                    record["metrics"] = {
                        "batch_duration_s": dt,
                        "batch_generated_tokens": gen_tokens,
                        "batch_tokens_per_second": gen_tokens / dt if dt > 0 else None,
                    }
                f.write(json.dumps(record, ensure_ascii=False) + "\n")
                request_id += 1
            LOGGER.info(
                f"Batch {start // step}: {real} prompts, {gen_tokens} tokens in {dt:.2f}s "
                f"({gen_tokens / dt:,.0f} tok/s)"
            )
