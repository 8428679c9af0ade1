"""Where a decode step's time goes: host wall, device-busy share and kernel
classes of the paged engine at the serving shape, on one CUDA card.

    python3 -m ssi_tpu_torch.profile_decode [--seed 0] [--json out.json]

The engine (``llama3_2_1b`` at full width, random bf16 weights from
``--seed``; 32 slots, page 128, chunk 16) admits 32 prompts of 32-700 tokens
and decodes greedily. After two warm-up chunks (the first one includes the
batched prefill) it reads, in this order:

1. three rounds, in turns, of (a) four engine steps (chunks)
   untraced: host wall per decode step (each step ends by copying its
   results to the host, so the wall includes the device drain) and (b)
   ``decode_step_tokens`` alone (the model step without sampling or the
   scheduler), as many calls as (a) has decode steps, at the current state:
   host enqueue time per call and the time to the end of the device drain.
   The spread over rounds is the host clock's noise;
2. four engine steps under ``torch.profiler``: the host wall of that
   window and, from the same trace, the union of device activity (kernels,
   copies, memsets), so ``busy / wall`` is one run's device-busy share, and
   the device time by kernel class; the profiler slows the host, so the
   traced wall is longer than the untraced;
3. one more round of (1), after the profiler has run, to show whether
   tracing leaves the host slower.

Times are from this run on the card named in the output; nothing falls back
to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ssi_tpu_torch.generate.engine import SamplingParams
from ssi_tpu_torch.generate.paged import decode_step_tokens
from ssi_tpu_torch.generate.paged_engine import PagedDecodeEngine
from ssi_tpu_torch.models.configs import get_model_config
from ssi_tpu_torch.models.llama3 import init_params

N_SLOTS, PAGE, CHUNK = 32, 128, 16
CHUNKS, ROUNDS = 4, 3  # engine chunks per timed window; untraced rounds before the traced one
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_CLASSES = (  # (class, substrings of the kernel name), first match wins
    ("paged kernel #8", ("paged_split_", "paged_merge_")),  # the split kernel and its merge
    ("flash kernel #1", ("flash_fwd_kernel",)),
    ("GEMM", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
    ("reduction", ("reduce", "softmax", "argmax", "norm")),
    ("copy/cast/index/cat", ("copy", "memcpy", "memset", "cat", "index", "gather", "scatter")),
    ("elementwise", ("elementwise",)),
)


def _classify(name: str) -> str:
    low = name.lower()
    for cls, keys in _CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def _device_summary(trace_path: str) -> dict:
    """Union of device intervals, their span, and busy time by kernel class."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    dev = [(e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in events
           if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS]
    if not dev:
        raise RuntimeError("the trace holds no device activity: the profiler did not trace the card")
    dev.sort()
    busy, cur_s, cur_e = 0.0, dev[0][0], dev[0][1]
    for s, e, _ in dev[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    by_class: dict[str, float] = {}
    for s, e, name in dev:
        by_class[_classify(name)] = by_class.get(_classify(name), 0.0) + (e - s)
    total = sum(by_class.values())
    return {
        "device_events": len(dev),
        "kernels": sum(1 for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"),
        "busy_ms": busy / 1e3,
        "span_ms": (max(e for _, e, _ in dev) - dev[0][0]) / 1e3,
        "share_of_device_time": {k: v / total for k, v in sorted(by_class.items(), key=lambda kv: -kv[1])},
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--json", default=None, help="also write the summary to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_decode: no CUDA device visible; this measures the card only", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    cfg = get_model_config("llama3_2_1b")
    cfg.n_dsus, cfg.modality_tokens = 5000, True
    params = init_params(cfg, seed=args.seed, dtype=torch.bfloat16, device="cuda")
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab_size, int(m)).tolist() for m in rng.integers(32, 701, N_SLOTS)]
    eng = PagedDecodeEngine(params, cfg, pad_id=0, n_slots=N_SLOTS, page_size=PAGE, prompt_bucket=PAGE, chunk=CHUNK)
    eng.begin_stream(SamplingParams(temperature=0.0, max_tokens=CHUNK * (CHUNKS * (ROUNDS + 2) + 4)))
    for p in prompts:
        eng.add_request(p)
    eng.step()  # admission + batched prefill + first chunk
    eng.step()
    st = eng._st

    steps = CHUNKS * CHUNK

    def one_round() -> dict:
        """(a) engine chunks, then (b) the model step alone as many times at
        the reached lengths; each (b) call rewrites the K/V cell that the
        next engine step writes first."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CHUNKS):
            eng.step()
        engine = (time.perf_counter() - t0) * 1e3 / steps
        tok, seq_lens = st.tok.clone(), st.seq_lens.clone()
        active = torch.ones(N_SLOTS, dtype=torch.bool, device="cuda")
        table = torch.from_numpy(eng._page_table).cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            decode_step_tokens(params, tok, cfg, eng.pools, table, seq_lens, active,
                               n_pages=eng.n_pages, attn_impl=eng.attn_impl)
        enqueue = (time.perf_counter() - t0) * 1e3 / steps
        torch.cuda.synchronize()
        drained = (time.perf_counter() - t0) * 1e3 / steps
        return {"engine_ms_per_step": engine, "model_step_alone_enqueue_ms": enqueue,
                "model_step_alone_drained_ms": drained}

    ctx = [st.seq_lens.float().mean().item()]
    rounds = [one_round() for _ in range(ROUNDS)]
    ctx.append(st.seq_lens.float().mean().item())

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "trace.json")
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(CHUNKS):
                eng.step()
            torch.cuda.synchronize()
            traced_wall = (time.perf_counter() - t0) * 1e3
        prof.export_chrome_trace(trace)
        dev = _device_summary(trace)

    ctx.append(st.seq_lens.float().mean().item())
    after = one_round()
    eng.end_stream()

    out = {
        "device": smi,
        "torch": torch.__version__,
        "shape": {"slots": N_SLOTS, "page": PAGE, "chunk": CHUNK, "chunks_per_window": CHUNKS,
                  "mean_context_at_window_starts": ctx},
        "untraced_rounds": rounds,
        "traced_wall_ms": traced_wall,
        "traced_ms_per_step": traced_wall / steps,
        "device_busy_ms": dev["busy_ms"],
        "device_busy_ms_per_step": dev["busy_ms"] / steps,
        "device_busy_share_of_traced_wall": dev["busy_ms"] / traced_wall,
        "device_span_ms": dev["span_ms"],
        "kernels_per_step": dev["kernels"] / steps,
        "share_of_device_time": dev["share_of_device_time"],
        "round_after_profiler": after,
    }
    text = json.dumps(out, indent=1)
    print(text, flush=True)
    if args.json:
        with open(args.json, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
