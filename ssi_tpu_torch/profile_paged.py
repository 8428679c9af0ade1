"""Calibrate the bf16 paged decode kernel (#8) on the card: what a call
costs with no pages, how fast one block streams pages, how fast a full
batch does, and what a TMA box costs. Run on a machine with a CUDA card::

    python3 -m ssi_tpu_torch.profile_paged [--json PATH]

Cases at Llama 3.2 1B's serving layout (8 kv heads of head_dim 64, n_rep 4,
page 128, a 1,280-token page table), each the device time a call of a CUDA
graph of 16 layers' launches in turn (no launch finds its pages in L2 from
the one before), best of two replays:

- ``empty``: 32 slots with no history (launch, block prologue and epilogue);
- ``one_slot``: one slot of 1,279 keys, 8 blocks, one an SM: one block's rate;
- ``uniform_639`` and ``uniform_1279``: 32 slots of 639 and 1,279 keys (the
  difference of the two gives the batch's marginal rate);
- ``ragged``: 32 slots of 0 to 1,279 keys (a few fixed, the rest drawn from a seed);
- ``one_slot_box_<n>``: ``one_slot`` with TMA boxes of n keys (the wrapper's
  box choice patched), so the cost a box shows against the boxes a call issues;
- ``ragged_split_<n>``: ``ragged`` with splits of at least n keys (the
  wrapper's ``SPLIT_KEYS`` patched): more, shorter blocks and merges against
  fewer, longer ones.

Prints one line a case, the card's name and power limit, and a JSON summary
as the last line.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from ssi_tpu_torch.generate import paged_cuda

SLOTS, HKV, N_REP, HD, PAGE, MAX_PAGES, LAYERS = 32, 8, 4, 64, 128, 10, 16


def graph_ms(calls, replays: int = 10) -> float:
    """Device time per call of ``calls`` captured in one CUDA graph and
    replayed (the host's enqueue cost left out)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # first use outside the capture
        for c in calls:
            c()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for c in calls:
            c()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * len(calls))


def case(gen, hist: list[int]) -> tuple[float, int]:
    """(device ms a call, history bytes a call) of #8 over slots of ``hist``
    history keys, every slot active, the 16 layers' page tables in turn."""
    slots = len(hist)
    n_pages = slots * MAX_PAGES
    rows = LAYERS * n_pages + 1
    kp = torch.randn((rows, PAGE, HKV * HD), generator=gen, device="cuda").to(torch.bfloat16)
    vp = torch.randn((rows, PAGE, HKV * HD), generator=gen, device="cuda").to(torch.bfloat16)
    q = torch.randn((slots, HKV * N_REP, HD), generator=gen, device="cuda").to(torch.bfloat16)
    kn = torch.randn((slots, HKV, HD), generator=gen, device="cuda").to(torch.bfloat16)
    vn = torch.randn((slots, HKV, HD), generator=gen, device="cuda").to(torch.bfloat16)
    hist_t = torch.tensor(hist, dtype=torch.int32, device="cuda")
    seq_lens = hist_t + 1
    logical = torch.randperm(n_pages, generator=gen, device="cuda").view(slots, MAX_PAGES).to(torch.int32)
    calls = []
    for layer in range(LAYERS):
        table = layer * n_pages + logical
        write = torch.gather(table, 1, (hist_t // PAGE)[:, None].long())[:, 0].contiguous()
        calls.append(lambda t=table, w=write: paged_cuda.paged_attention_fused(q, kp, vp, t, seq_lens, k_new=kn,
                                                                              v_new=vn, write_rows=w))
    t = min(graph_ms(calls), graph_ms(calls))
    return t, sum(hist) * HKV * HD * 2 * 2


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--json", help="also write the summary to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_paged needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    ctx = PAGE * MAX_PAGES
    lengths = torch.randint(1, ctx + 1, (SLOTS - 5,), generator=torch.Generator().manual_seed(0)).tolist()
    ragged = [1, PAGE, 2 * PAGE - 3, ctx, 1] + lengths
    cases = {"empty": [0] * SLOTS, "one_slot": [ctx - 1], "uniform_639": [639] * SLOTS,
             "uniform_1279": [ctx - 1] * SLOTS, "ragged": [n - 1 for n in ragged]}
    out = {"card": card, "cases": {}}
    for name, hist in cases.items():
        t, n_bytes = case(gen, hist)
        out["cases"][name] = {"ms": t, "history_bytes": n_bytes, "gb_per_s": n_bytes / (t * 1e-3) / 1e9}
        print(f"{name:18s} {t:.4f} ms, {n_bytes / 1e6:.1f} MB of pages, {n_bytes / (t * 1e-3) / 1e9:.0f} GB/s",
              flush=True)
    box_keys = paged_cuda.box_keys
    try:
        for box in (128, 64, 32, 16):
            paged_cuda.box_keys = lambda ps, hd, box=box: box
            t, n_bytes = case(gen, cases["one_slot"])
            boxes = HKV * 2 * -(-(ctx - 1) // box)
            out["cases"][f"one_slot_box_{box}"] = {"ms": t, "boxes": boxes}
            print(f"one_slot_box_{box:<5d} {t:.4f} ms, {boxes} boxes", flush=True)
    finally:
        paged_cuda.box_keys = box_keys
    split_keys = paged_cuda.SPLIT_KEYS
    try:
        for keys in (256, 512, 640, 1280):
            paged_cuda.SPLIT_KEYS = keys
            t, _ = case(gen, cases["ragged"])
            splits = paged_cuda.split_plan(MAX_PAGES, PAGE)[1]
            out["cases"][f"ragged_split_{keys}"] = {"ms": t, "splits": splits}
            print(f"ragged_split_{keys:<4d} {t:.4f} ms, {splits} splits", flush=True)
    finally:
        paged_cuda.SPLIT_KEYS = split_keys
    u1, u2 = out["cases"]["uniform_639"], out["cases"]["uniform_1279"]
    out["marginal_gb_per_s"] = (u2["history_bytes"] - u1["history_bytes"]) / ((u2["ms"] - u1["ms"]) * 1e-3) / 1e9
    print(card)
    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
