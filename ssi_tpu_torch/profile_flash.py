"""Time the bf16 flash-attention kernels on the card at the main path's
shapes beside PyTorch's ``scaled_dot_product_attention``, then split each
backward's device time by kernel (delta, dK/dV, dQ) with a
``torch.profiler`` window a shape. Run on a machine with a CUDA card::

    python3 -m ssi_tpu_torch.profile_flash [--json PATH]

Shapes, all causal: head_dim 128 at Llama 3.2 3B's training shape (B 2,
S 2048, 24 q / 8 kv heads) and Llama 3.1 8B's largest prefill dispatch (B 8,
S 768, 32 / 8); head_dim 64 at the 1B training shape (B 2, S 2048, 32 / 8).
Kernel and SDPA run in turns (kernel, SDPA, SDPA, kernel; best of each),
timed with CUDA events over 20 launches after 3 warm-up launches; the
profiler window comes after every timing, as a traced process stays slower.
Prints one line a shape and a JSON summary as the last line.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess

import torch
import torch.nn.functional as F

from ssi_tpu_torch.ops.flash_attention import flash_attention_bwd, flash_attention_fwd

SHAPES = {"3b_train": (2, 2048, 24, 8, 128), "8b_prefill": (8, 768, 32, 8, 128), "1b_train": (2, 2048, 32, 8, 64)}


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(kernel, library) -> tuple[float, float]:
    k1, l1, l2, k2 = time_ms(kernel), time_ms(library), time_ms(library), time_ms(kernel)
    return min(k1, k2), min(l1, l2)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--json", help="also write the summary to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_flash needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    inputs, rows = {}, {}
    for name, (b, s, hq, hkv, d) in SHAPES.items():
        q, k, v, do = (torch.randn((b, s, h, d), generator=gen, device="cuda").to(torch.bfloat16)
                       for h in (hq, hkv, hkv, hq))
        o, lse = flash_attention_fwd(q, k, v, causal=True)
        inputs[name] = (q, k, v, o, lse, do)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        dot = do.transpose(1, 2)
        fwd, sdpa = in_turns(lambda: flash_attention_fwd(q, k, v, causal=True),
                             lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True))
        bwd, sdpa_bwd = in_turns(lambda: flash_attention_bwd(q, k, v, o, lse, do, causal=True),
                                 lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True))
        flops = 4 * b * hq * d * s * (s + 1) / 2  # QK^T and PV over the allowed causal pairs
        rows[name] = {"shape": [b, s, hq, hkv, d], "fwd_ms": fwd, "sdpa_ms": sdpa, "bwd_ms": bwd,
                      "sdpa_bwd_ms": sdpa_bwd, "fwd_tflops": flops / fwd / 1e9,
                      "bwd_tflops_5_products": 2.5 * flops / bwd / 1e9}
        print(f"{name} B{b} S{s} {hq}/{hkv} d{d}: fwd {fwd:.4f} ms ({flops / fwd / 1e9:.0f} TFLOP/s), SDPA "
              f"{sdpa:.4f}; bwd {bwd:.4f} ms ({2.5 * flops / bwd / 1e9:.0f} TFLOP/s on 5 products), SDPA backward "
              f"{sdpa_bwd:.4f} ms", flush=True)
        del out, qt, kt, vt, dot
    # device time by kernel, one window per shape, after every timing above
    for name, (q, k, v, o, lse, do) in inputs.items():
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                flash_attention_bwd(q, k, v, o, lse, do, causal=True)
            torch.cuda.synchronize()
        split = {}
        for e in prof.key_averages():
            kname = re.search(r"\w+_kernel", e.key)
            if kname and e.device_time_total > 0:
                split[kname.group(0)] = e.device_time_total / e.count / 1e3
        rows[name]["bwd_kernel_ms"] = split
        print(f"{name} backward by kernel: " + ", ".join(f"{kname} {ms:.4f} ms" for kname, ms in split.items()),
              flush=True)
    summary = {"card": card, "shapes": rows}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
