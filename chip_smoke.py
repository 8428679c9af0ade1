#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``ssi_tpu_torch``) on one GPU.

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py [--seed 0]

Phases (each prints one progress line; any failure raises and exits
non-zero without printing the final line):

0. device: a CUDA card must be present (no CPU fallback); prints the card's
   name and power limit (nvidia-smi), torch / CUDA / nvcc versions;
1. build: both CUDA kernels from ``ssi_tpu_torch/csrc`` with nvcc;
2. flash-attention forward kernel vs its plain version (f32 and bf16;
   causal, full, segment ids) at the main path's largest prefill dispatch
   (B 8, S 768) and the training shapes, and times;
3. fused paged-decode kernel vs its plain version at the 1B serving shape
   (32 slots, page 128, context 1280; ragged and inactive slots): attention
   within tolerance, pools bitwise equal except the trash row; times;
4. engine in f32 at the full width of ``llama3_2_1b`` (random weights from
   ``--seed``): greedy tokens identical with the kernels and with the plain
   versions, and equal to a full-recompute greedy oracle for one prompt;
5. the main path: the 1B bf16 engine serves 64 requests (32 slots, 128
   tokens each); every request finishes, every page is freed, and both
   kernels' launch counters are > 0 for that run.

It then prints one JSON line with per-kernel results and, last, the device
line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FLASH_REPLACES = "ssi_tpu/ops/flash_attention.py:76"  # _fwd_kernel (and _fwd_kernel_grouped, :174)
PAGED_REPLACES = "ssi_tpu/generate/paged_pallas.py:83"  # paged_attention_pallas -> _kernel
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip smoke check failed: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    from ssi_tpu_torch import _build

    nvcc = _build.find_nvcc()
    nvcc_v = subprocess.run([nvcc, "--version"], capture_output=True, text=True, timeout=60, check=True).stdout
    log(smi)
    log(
        f"phase 0 device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"nvcc {nvcc_v.strip().splitlines()[-1]}"
    )
    return smi


def phase_build():
    from ssi_tpu_torch import _build

    _build.load_library()
    ptxas = [ln.strip() for ln in _build.build_log.splitlines() if "registers" in ln or "spill" in ln]
    for ln in ptxas:
        log(f"  ptxas: {ln}")
    log(f"phase 1 build: {_build.build_seconds:.1f} s (0.0 = cached library reused)")


def phase_flash(gen):
    import torch

    from ssi_tpu_torch.ops.flash_attention import flash_attention_fwd, flash_attention_reference

    hq, hkv, d = 32, 8, 64
    worst = {}
    # B8 S768 is the main path's largest prefill dispatch (8 prompts, bucket 768), also timed below
    for b, s in ((8, 768), (2, 768), (1, 2048)):
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((b, s, hq, d), generator=gen, device="cuda").to(dtype)
            k = torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(dtype)
            v = torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(dtype)
            cuts = sorted(torch.randint(1, s, (3,), generator=gen, device="cuda").tolist())
            seg = torch.zeros((b, s), dtype=torch.int32, device="cuda")
            for c in cuts:
                seg[:, c:] += 1
            for name, causal, segs in (("causal", True, None), ("full", False, None), ("segments", True, seg)):
                o, lse = flash_attention_fwd(q, k, v, causal=causal, segment_ids=segs)
                o_ref, lse_ref = flash_attention_reference(q, k, v, causal=causal, segment_ids=segs)
                torch.cuda.synchronize()
                tol = TOL[str(dtype).split(".")[1]]
                err_o = (o.float() - o_ref.float()).abs().max().item()
                err_l = (lse - lse_ref).abs().max().item()
                ok_o = torch.allclose(o.float(), o_ref.float(), atol=tol, rtol=tol)
                ok_l = torch.allclose(lse, lse_ref, atol=tol, rtol=tol)
                check(ok_o and ok_l, f"flash {name} B{b} S{s} {dtype}: o err {err_o}, lse err {err_l}, tol {tol}")
                key = str(dtype).split(".")[1]
                worst[key] = max(worst.get(key, 0.0), err_o, err_l)
                log(f"  flash {name:8s} B{b} S{s} {key:8s}: max|o err| {err_o:.3e}, max|lse err| {err_l:.3e} (tol {tol})")
    # times at the checked shapes; the kernels line reports B8 S768
    times = {}
    for b, s in ((8, 768), (2, 768), (1, 2048)):
        q = torch.randn((b, s, hq, d), generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
        t_plain = time_ms(lambda: flash_attention_reference(q, k, v, causal=True))
        t_kernel = time_ms(lambda: flash_attention_fwd(q, k, v, causal=True))
        t_kernel2 = time_ms(lambda: flash_attention_fwd(q, k, v, causal=True))
        t_plain2 = time_ms(lambda: flash_attention_reference(q, k, v, causal=True))
        times[(b, s)] = (min(t_kernel, t_kernel2), min(t_plain, t_plain2))
        # useful causal work: QK^T and PV over the S(S+1)/2 allowed pairs, 2 FLOP per MAC
        tflops = 4 * b * hq * d * s * (s + 1) / 2 / (times[(b, s)][0] * 1e-3) / 1e12
        log(f"  flash time bf16 causal B{b} S{s}: kernel {times[(b, s)][0]:.3f} ms ({tflops:.1f} TFLOP/s = "
            f"{tflops / 989:.1%} of the bf16 tensor-core peak), plain {times[(b, s)][1]:.3f} ms")
    log(f"phase 2 flash forward: ok (max err f32 {worst['float32']:.3e}, bf16 {worst['bfloat16']:.3e})")
    return worst, times[(8, 768)]


def phase_paged(gen):
    import torch

    from ssi_tpu_torch.generate.paged_cuda import paged_attention_fused, paged_attention_fused_reference

    slots, hq, hkv, hd, ps, max_ctx, n_layers = 32, 32, 8, 64, 128, 1280, 16
    max_pages = max_ctx // ps
    n_pages = slots * max_pages
    rows = n_layers * n_pages + 1
    trash = rows - 1
    layer = 5
    lens = [1, ps, 2 * ps - 3, max_ctx, 0]  # 0 = inactive slot
    lens += torch.randint(1, max_ctx + 1, (slots - len(lens),), generator=gen, device="cuda").tolist()
    seq_lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    active = seq_lens > 0
    logical = torch.randperm(n_pages, generator=gen, device="cuda").view(slots, max_pages).to(torch.int32)
    table = layer * n_pages + logical
    hist = (seq_lens - 1).clamp(min=0)
    write_rows = torch.where(active, torch.gather(table, 1, (hist // ps)[:, None].long())[:, 0],
                             torch.full_like(seq_lens, trash))
    worst, timing = {}, None
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype).split(".")[1]
        tol = TOL[key]
        kp = torch.randn((rows, ps, hkv * hd), generator=gen, device="cuda").to(dtype)
        vp = torch.randn((rows, ps, hkv * hd), generator=gen, device="cuda").to(dtype)
        q = torch.randn((slots, hq, hd), generator=gen, device="cuda").to(dtype)
        kn = torch.randn((slots, hkv, hd), generator=gen, device="cuda").to(dtype)
        vn = torch.randn((slots, hkv, hd), generator=gen, device="cuda").to(dtype)
        kp_ref, vp_ref = kp.clone(), vp.clone()
        got = paged_attention_fused(q, kp, vp, table, seq_lens, k_new=kn, v_new=vn, write_rows=write_rows)
        ref = paged_attention_fused_reference(q, kp_ref, vp_ref, table, seq_lens, k_new=kn, v_new=vn,
                                              write_rows=write_rows)
        torch.cuda.synchronize()
        err = (got[active].float() - ref[active].float()).abs().max().item()
        check(torch.allclose(got[active].float(), ref[active].float(), atol=tol, rtol=tol),
              f"paged attention {key}: max err {err} > tol {tol}")
        check(torch.equal(kp[:-1], kp_ref[:-1]) and torch.equal(vp[:-1], vp_ref[:-1]),
              f"paged pools {key}: not bitwise equal outside the trash row")
        worst[key] = err
        log(f"  paged {key:8s}: max|attn err| {err:.3e} (tol {tol}); pools bitwise equal except trash")
        if dtype == torch.bfloat16:
            def kernel():
                return paged_attention_fused(q, kp, vp, table, seq_lens, k_new=kn, v_new=vn, write_rows=write_rows)

            def plain():
                return paged_attention_fused_reference(q, kp_ref, vp_ref, table, seq_lens, k_new=kn, v_new=vn,
                                                       write_rows=write_rows)

            t_p, t_k, t_k2, t_p2 = time_ms(plain), time_ms(kernel), time_ms(kernel), time_ms(plain)
            timing = (min(t_k, t_k2), min(t_p, t_p2))
            # bytes the algorithm must read: every history K and V row of every active slot
            n_bytes = int(hist[active].sum().item()) * hkv * hd * kp.element_size() * 2
            gbs = n_bytes / (timing[0] * 1e-3) / 1e9
            log(f"  paged time bf16, 32 slots, one layer: kernel {timing[0]:.3f} ms ({n_bytes / 1e6:.1f} MB of "
                f"pages, {gbs:.0f} GB/s = {gbs / 3350:.1%} of 3.35 TB/s), plain {timing[1]:.3f} ms")
        del kp, vp, kp_ref, vp_ref
    log(f"phase 3 paged decode: ok (max err f32 {worst['float32']:.3e}, bf16 {worst['bfloat16']:.3e})")
    return worst, timing


def model_config():
    from ssi_tpu_torch.models.configs import get_model_config

    cfg = get_model_config("llama3_2_1b")
    cfg.n_dsus = 5000
    cfg.modality_tokens = True
    return cfg


def prompts_from_seed(seed: int, n: int, vocab: int) -> list[list[int]]:
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(m)).tolist() for m in rng.integers(32, 701, n)]


def naive_greedy(params, cfg, prompt, n_tokens):
    """Full-recompute greedy decode (plain attention, no cache)."""
    import torch

    from ssi_tpu_torch.models.llama3 import forward, logits

    toks = list(prompt)
    for _ in range(n_tokens):
        x = torch.tensor([toks], dtype=torch.int64, device="cuda")
        h = forward(params, x, cfg)[:, -1]
        toks.append(int(torch.argmax(logits(params, h), dim=-1).item()))
    return toks[len(prompt):]


def phase_engine_f32(seed: int):
    import torch

    from ssi_tpu_torch.generate.engine import SamplingParams
    from ssi_tpu_torch.generate.paged_engine import PagedDecodeEngine
    from ssi_tpu_torch.models.llama3 import init_params

    cfg = model_config()
    params = init_params(cfg, seed=seed, dtype=torch.float32, device="cuda")
    prompts = prompts_from_seed(seed, 4, cfg.vocab_size)
    sp = SamplingParams(temperature=0.0, max_tokens=16)
    outs = {}
    for impl in ("kernel", "reference"):
        eng = PagedDecodeEngine(params, cfg, pad_id=0, n_slots=4, attn_impl=impl)
        outs[impl] = eng.generate_batch(prompts, sp)
        del eng
    for i, (a, b) in enumerate(zip(outs["kernel"], outs["reference"])):
        check(a["token_ids"] == b["token_ids"], f"f32 engine prompt {i}: kernel {a['token_ids']} != plain {b['token_ids']}")
        check(len(a["token_ids"]) == 16, f"f32 engine prompt {i}: {len(a['token_ids'])} tokens")
    dlp = max(abs(a["cumulative_logprob"] - b["cumulative_logprob"]) for a, b in zip(outs["kernel"], outs["reference"]))
    oracle = naive_greedy(params, cfg, prompts[0], 16)
    check(outs["kernel"][0]["token_ids"] == oracle, f"f32 engine prompt 0 != full-recompute greedy {oracle}")
    log(f"phase 4 engine f32 (1B width, vocab {cfg.vocab_size}): 4 prompts x 16 greedy tokens identical "
        f"kernel vs plain and vs full recompute; max |cum logprob diff| {dlp:.2e}")
    del params
    torch.cuda.empty_cache()


def phase_engine_bf16(seed: int, smi: str):
    import torch

    from ssi_tpu_torch import _build
    from ssi_tpu_torch.generate.engine import SamplingParams
    from ssi_tpu_torch.generate.paged_engine import PagedDecodeEngine
    from ssi_tpu_torch.models.llama3 import init_params

    cfg = model_config()
    params = init_params(cfg, seed=seed, dtype=torch.bfloat16, device="cuda")
    prompts = prompts_from_seed(seed + 1, 64, cfg.vocab_size)
    sp = SamplingParams(temperature=0.0, max_tokens=128)
    eng = PagedDecodeEngine(params, cfg, pad_id=0, n_slots=32, page_size=128, prompt_bucket=128, chunk=16)
    check(eng.attn_impl == "kernel", f"engine on CUDA resolved attn_impl {eng.attn_impl!r}")
    eng.generate_batch(prompts[:8], SamplingParams(max_tokens=16))  # warm-up: CUDA/cuBLAS first-use costs
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    t0 = time.perf_counter()
    outs = eng.generate_batch(prompts, sp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    for i, o in enumerate(outs):
        check(o["finish_reason"] == "length" and len(o["token_ids"]) == 128,
              f"request {i}: {o['finish_reason']}, {len(o['token_ids'])} tokens")
        check(all(0 <= t < cfg.vocab_size for t in o["token_ids"]), f"request {i}: token out of vocab")
    check(len(eng._free_pages) == eng.n_pages, f"pages leaked: {eng.n_pages - len(eng._free_pages)}")
    for name in ("flash_attention_fwd", "paged_attention_fused"):
        check(launches.get(name, 0) > 0, f"kernel {name} was not launched on the main path")
    n_tok = sum(len(o["token_ids"]) for o in outs)
    s = eng.last_stats
    log(f"phase 5 engine bf16 main path: 64 requests x 128 tokens, {n_tok} tokens in {wall:.2f} s = "
        f"{n_tok / wall:.0f} generated tok/s on {smi} (wall clock incl. prefill, after a warm-up batch; "
        f"{s['chunk_dispatches']} chunks, "
        f"{s['prefill_dispatches']} prefill dispatches, occupancy {s['slot_occupancy']:.3f}); launches {launches}")
    return launches


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this check runs only on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)

    smi = phase_device()
    phase_build()
    flash_err, flash_t = phase_flash(gen)
    paged_err, paged_t = phase_paged(gen)
    phase_engine_f32(args.seed)
    launches = phase_engine_bf16(args.seed, smi)

    kernels = [
        {"name": "flash_attention_fwd", "route": "cuda", "source": "ssi_tpu_torch/csrc/flash_attention_fwd.cu",
         "replaces": FLASH_REPLACES, "launches": launches["flash_attention_fwd"],
         "max_abs_err": flash_err["bfloat16"], "ms": flash_t[0], "plain_ms": flash_t[1]},
        {"name": "paged_attention_fused", "route": "cuda", "source": "ssi_tpu_torch/csrc/paged_attention.cu",
         "replaces": PAGED_REPLACES, "launches": launches["paged_attention_fused"],
         "max_abs_err": paged_err["bfloat16"], "ms": paged_t[0], "plain_ms": paged_t[1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
