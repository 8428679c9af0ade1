#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``ssi_tpu_torch``) on one GPU.

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py [--seed 0]

Phases (each prints one progress line; any failure raises and exits
non-zero without printing the final line):

0. device: a CUDA card must be present (no CPU fallback); prints the card's
   name and power limit (nvidia-smi), torch / CUDA / nvcc versions;
1. build: every CUDA kernel from ``ssi_tpu_torch/csrc`` (one nvcc per source,
   in parallel, then one link);
2. flash-attention forward kernel vs its plain version (f32 and bf16;
   causal, full, segment ids) at the serving path's largest prefill dispatch
   (B 8, S 768), at B 2 x S 768, and at the training path's B 2 x S 2048;
   times;
3. fused paged-decode kernel vs its plain version at the 1B serving shape
   (32 slots, page 128, context 1280; ragged and inactive slots): attention
   within tolerance, pools bitwise equal except the trash row; times;
4. engine in f32 at the full width of ``llama3_2_1b`` (random weights from
   ``--seed``): greedy tokens identical with the kernels and with the plain
   versions, and equal to a full-recompute greedy oracle for one prompt;
5. the serving main path: the 1B bf16 engine serves 64 requests (32 slots,
   128 tokens each); every request finishes, every page is freed, and both
   serving kernels' launch counters are > 0 for that run;
6. flash-attention backward kernel vs its plain version (dq, dk, dv; f32 and
   bf16; causal, full, segment ids) at B 4, S 768 and the training shape
   B 2, S 2048, with the plain gradients at lse + 0.05 as the control; times
   beside the backward of PyTorch's ``scaled_dot_product_attention`` (timed
   only, as a yardstick);
7. the three cross-entropy kernels (lse, dh, dE) and the loss vs their plain
   versions at N 4,096 and 3,072 tokens, D 2048, V 133,258 (f32 and bf16,
   every 7th label ignored), at the init logit spread and a trained-like one
   (std 4); dE's labelled and unlabelled vocab rows held apart; controls: a
   constant lse, lse + 0.05, dh without its softmax term; times beside
   ``F.cross_entropy(h @ E.T, y)`` and its backward;
8. f32 train-step parity at the full width of ``llama3_2_1b``: one
   micro-batch of B 1, S 512 through ``make_loss_fn`` (the kernels) and
   through the plain attention and cross-entropy on the card: loss and every
   leaf's gradient agree;
9. the training main path: ``make_train_step`` on the 1B bf16 model with
   the SFT window (accum 4 x micro-batch 2 x seq 2048), full remat, f32
   gradient accumulation, clip 1.0, AdamW defaults: a zero-token warm-up
   window (no update, step not advanced), then 3 timed optimizer steps on
   one repeated window; every loss finite, step 3, the third loss below the
   first, and every training kernel's launch counter > 0 for the timed run.

Tolerances: phases 2 and 3 hold each output elementwise to ``TOL`` (absolute
and relative). Every kernel output is also held in relative norm,
||kernel - plain|| / ||plain|| <= ``REL`` (1e-4 f32, 1e-2 bf16), and in
phases 6 and 7 each such check comes with a control, a deliberately wrong
result that must miss the same limit. The cross-entropy lse is held to
``LSE_ATOL`` absolute and the loss to 1e-5 of its sum; phase 8 holds each
gradient leaf to 1e-4 of its largest entry.
It then prints one JSON line with per-kernel results (errors, times, the
bound computed from this run's shapes, the library yardstick) and, last,
the device line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FLASH_REPLACES = "ssi_tpu/ops/flash_attention.py:76"  # _fwd_kernel (and _fwd_kernel_grouped, :174)
FLASH_BWD_REPLACES = "ssi_tpu/ops/flash_attention.py:263"  # _bwd_kernel (and _bwd_kernel_grouped, :365)
PAGED_REPLACES = "ssi_tpu/generate/paged_pallas.py:83"  # paged_attention_pallas -> _kernel
CE_REPLACES = {
    "cross_entropy_lse": "ssi_tpu/ops/cross_entropy_pallas.py:53",  # _compute_lse -> _lse_kernel
    "cross_entropy_dh": "ssi_tpu/ops/cross_entropy_pallas.py:108",  # _bwd_rule -> _dh_kernel
    "cross_entropy_de": "ssi_tpu/ops/cross_entropy_pallas.py:137",  # _bwd_rule -> _de_kernel
}
TRAIN_KERNELS = ("flash_attention_fwd", "flash_attention_bwd", "cross_entropy_lse", "cross_entropy_dh",
                 "cross_entropy_de")
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# limit on ||kernel - plain|| / ||plain|| over one output tensor (or one set of its rows)
REL = {"float32": 1e-4, "bfloat16": 1e-2}
LSE_ATOL = 1e-3  # cross-entropy lse, absolute: well below its row-to-row spread
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 bandwidth


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip smoke check failed: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(a, w) -> float:
    """||a - w|| / ||w|| over all entries, summed in f64."""
    a, w = a.double(), w.double()
    return ((a - w).norm() / w.norm().clamp_min(1e-300)).item()


def hold(what: str, a, w, key: str, controls=()) -> tuple[float, float, float]:
    """Hold the kernel's ``a`` to the plain ``w`` within ``REL[key]`` in
    relative norm; each control, a deliberately wrong result ``(name, c)``,
    must miss the same limit, or the check could not tell. Returns
    (max |a - w|, relative error, the smallest control's relative error)."""
    limit = REL[key]
    rel = rel_err(a, w)
    check(rel <= limit, f"{what} {key}: ||kernel - plain|| / ||plain|| = {rel:.3e} > {limit}")
    least = math.inf
    for name, c in controls:
        rc = rel_err(c, w)
        check(rc > limit, f"{what} {key}: the control '{name}' passes ({rc:.3e} <= {limit}), so the check cannot tell")
        least = min(least, rc)
    return (a.float() - w.float()).abs().max().item(), rel, least


def bound(ops: float, n_bytes: float) -> tuple[float, str]:
    """Least time the card could take (ms): the larger of the operations at
    the bf16 tensor-core peak and the bytes at the memory rate; which bounds."""
    t_ops, t_bytes = ops / PEAK_BF16_FLOPS * 1e3, n_bytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def in_turns(kernel, plain, iters: int = 10) -> tuple[float, float]:
    """(kernel ms, plain ms), best of two each, timed plain, kernel, kernel, plain."""
    t_p, t_k, t_k2, t_p2 = time_ms(plain, iters), time_ms(kernel, iters), time_ms(kernel, iters), time_ms(plain, iters)
    return min(t_k, t_k2), min(t_p, t_p2)


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
    import torch.nn.functional as F

    from ssi_tpu_torch.ops.flash_attention import flash_attention_fwd, flash_attention_reference

    hq, hkv, d = 32, 8, 64
    worst = {}
    # B8 S768 is the main path's largest prefill dispatch (8 prompts, bucket 768), also timed below
    for b, s in ((8, 768), (2, 768), (2, 2048)):
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
                _, rel_o, _ = hold(f"flash {name} B{b} S{s} o", o, o_ref, key)
                worst[key] = max(worst.get(key, 0.0), err_o, err_l)
                log(f"  flash {name:8s} B{b} S{s} {key:8s}: max|o err| {err_o:.3e}, max|lse err| {err_l:.3e} "
                    f"(tol {tol}); o rel {rel_o:.2e} (limit {REL[key]})")
    # times at the checked shapes; the kernels line reports B8 S768
    times = {}
    for b, s in ((8, 768), (2, 768), (2, 2048)):
        q = torch.randn((b, s, hq, d), generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
        times[(b, s)] = in_turns(lambda: flash_attention_fwd(q, k, v, causal=True),
                                 lambda: flash_attention_reference(q, k, v, causal=True))
        # useful causal work: QK^T and PV over the S(S+1)/2 allowed pairs, 2 FLOP per MAC
        tflops = 4 * b * hq * d * s * (s + 1) / 2 / (times[(b, s)][0] * 1e-3) / 1e12
        log(f"  flash time bf16 causal B{b} S{s}: kernel {times[(b, s)][0]:.3f} ms ({tflops:.1f} TFLOP/s = "
            f"{tflops / 989:.1%} of the bf16 tensor-core peak), plain {times[(b, s)][1]:.3f} ms")
    # the kernels line reports B8 S768: bound from its shapes, and one PyTorch call as the yardstick
    b, s = 8, 768
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda").to(torch.bfloat16) for h in (hq, hkv, hkv))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True))
    n_bytes = 2 * (2 * b * s * hq * d + 2 * b * s * hkv * d) + 4 * b * hq * s  # q, o; k, v; lse
    bound_ms, bound_by = bound(4 * b * hq * d * s * (s + 1) / 2, n_bytes)
    log(f"  flash B8 S768: bound {bound_ms:.4f} ms ({bound_by}); scaled_dot_product_attention {library:.3f} ms")
    log(f"phase 2 flash forward: ok (max err f32 {worst['float32']:.3e}, bf16 {worst['bfloat16']:.3e})")
    return {"max_abs_err": worst["bfloat16"], "ms": times[(8, 768)][0], "plain_ms": times[(8, 768)][1],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library}


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
        _, rel, _ = hold("paged attention", got[active], ref[active], key)
        check(torch.equal(kp[:-1], kp_ref[:-1]) and torch.equal(vp[:-1], vp_ref[:-1]),
              f"paged pools {key}: not bitwise equal outside the trash row")
        worst[key] = err
        log(f"  paged {key:8s}: max|attn err| {err:.3e} (tol {tol}), rel {rel:.2e} (limit {REL[key]}); "
            "pools bitwise equal except trash")
        if dtype == torch.bfloat16:
            def kernel():
                return paged_attention_fused(q, kp, vp, table, seq_lens, k_new=kn, v_new=vn, write_rows=write_rows)

            def plain():
                return paged_attention_fused_reference(q, kp_ref, vp_ref, table, seq_lens, k_new=kn, v_new=vn,
                                                       write_rows=write_rows)

            timing = in_turns(kernel, plain)
            # bytes the algorithm must read: every history K and V row of every active slot
            n_bytes = int(hist[active].sum().item()) * hkv * hd * kp.element_size() * 2
            gbs = n_bytes / (timing[0] * 1e-3) / 1e9
            log(f"  paged time bf16, 32 slots, one layer: kernel {timing[0]:.3f} ms ({n_bytes / 1e6:.1f} MB of "
                f"pages, {gbs:.0f} GB/s = {gbs / 3350:.1%} of 3.35 TB/s), plain {timing[1]:.3f} ms")
            # bound: those pages, q read and out written, the new K/V read and written once
            n_tokens = int(hist[active].sum().item())
            ops = 4 * n_tokens * hq * hd
            bound_ms, bound_by = bound(ops, n_bytes + 2 * 2 * slots * hq * hd + 4 * 2 * slots * hkv * hd)
            log(f"  paged bound {bound_ms:.4f} ms ({bound_by}); no single PyTorch call computes it")
        del kp, vp, kp_ref, vp_ref
    log(f"phase 3 paged decode: ok (max err f32 {worst['float32']:.3e}, bf16 {worst['bfloat16']:.3e})")
    return {"max_abs_err": worst["bfloat16"], "ms": timing[0], "plain_ms": timing[1], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


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


def plain_hidden(params, tokens, cfg):
    """The decoder through the plain attention on the card (no kernel, no
    remat): the reference the kernel paths are held to."""
    import torch

    from ssi_tpu_torch.models.llama3 import block, rms_norm, rope_for_positions
    from ssi_tpu_torch.ops.attention import reference_attention

    b, s = tokens.shape
    cos, sin = rope_for_positions(torch.arange(s, dtype=torch.int32, device=tokens.device)[None].expand(b, s), cfg)
    h = params["embed"][tokens]
    names = list(params["layers"])
    for weights in zip(*(params["layers"][n].unbind(0) for n in names)):
        h = block(h, dict(zip(names, weights)), cos, sin, cfg,
                  lambda q, k, v: reference_attention(q, k, v, causal=True))
    return rms_norm(h, params["final_norm"], cfg.norm_eps)


def plain_loss(params, tokens, labels, cfg):
    """``make_loss_fn``'s loss sum through the plain attention and the plain cross-entropy."""
    from ssi_tpu_torch.models.llama3 import unembed
    from ssi_tpu_torch.ops.cross_entropy import fused_cross_entropy
    from ssi_tpu_torch.train.step import shift_labels

    h = plain_hidden(params, tokens, cfg)
    return fused_cross_entropy(h.reshape(-1, h.shape[-1]), unembed(params), shift_labels(labels).reshape(-1))


def naive_greedy(params, cfg, prompt, n_tokens):
    """Full-recompute greedy decode (plain attention, no cache, no kernel)."""
    import torch

    from ssi_tpu_torch.models.llama3 import logits

    toks = list(prompt)
    for _ in range(n_tokens):
        x = torch.tensor([toks], dtype=torch.int64, device="cuda")
        h = plain_hidden(params, x, cfg)[:, -1]
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


def phase_flash_bwd(gen):
    import torch
    import torch.nn.functional as F

    from ssi_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_reference,
        flash_attention_fwd,
    )

    hq, hkv, d = 32, 8, 64
    worst, worst_rel = {}, {}
    for b, s in ((4, 768), (2, 2048)):  # B2 S2048 is the training path's shape
        for dtype in (torch.float32, torch.bfloat16):
            key = str(dtype).split(".")[1]
            q, k, v, do = (torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
                           for h in (hq, hkv, hkv, hq))
            seg = torch.zeros((b, s), dtype=torch.int32, device="cuda")
            for c in sorted(torch.randint(1, s, (3,), generator=gen, device="cuda").tolist()):
                seg[:, c:] += 1
            for name, causal, segs in (("causal", True, None), ("full", False, None), ("segments", True, seg)):
                o, lse = flash_attention_fwd(q, k, v, causal=causal, segment_ids=segs)
                got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal, segment_ids=segs)
                want = flash_attention_bwd_reference(q, k, v, o, lse, do, causal=causal, segment_ids=segs)
                # control: the plain gradients with every probability 5% low (lse + 0.05)
                ctrl = flash_attention_bwd_reference(q, k, v, o, lse + 0.05, do, causal=causal, segment_ids=segs)
                torch.cuda.synchronize()
                errs, rels, least = [], [], math.inf
                for gname, a, w, c in zip(("dq", "dk", "dv"), got, want, ctrl):
                    check(a.dtype == dtype, f"flash bwd {gname} dtype {a.dtype} != {dtype}")
                    err, rel, rc = hold(f"flash bwd {name} B{b} S{s} {gname}", a, w, key, [("p x 0.95", c)])
                    errs.append(err)
                    rels.append(rel)
                    least = min(least, rc)
                worst[key] = max(worst.get(key, 0.0), *errs)
                worst_rel[key] = max(worst_rel.get(key, 0.0), *rels)
                log(f"  flash bwd {name:8s} B{b} S{s} {key:8s}: rel dq {rels[0]:.2e}, dk {rels[1]:.2e}, "
                    f"dv {rels[2]:.2e} (limit {REL[key]}; control p x 0.95 >= {least:.2e}); max|err| dq {errs[0]:.3e}, "
                    f"dk {errs[1]:.3e}, dv {errs[2]:.3e}")
                del o, lse, got, want, ctrl
            del q, k, v, do
            torch.cuda.empty_cache()
    rows = {}
    for b, s in ((4, 768), (2, 2048)):
        q, k, v, do = (torch.randn((b, s, h, d), generator=gen, device="cuda").to(torch.bfloat16)
                       for h in (hq, hkv, hkv, hq))
        o, lse = flash_attention_fwd(q, k, v, causal=True)
        t_k, t_p = in_turns(lambda: flash_attention_bwd(q, k, v, o, lse, do, causal=True),
                            lambda: flash_attention_bwd_reference(q, k, v, o, lse, do, causal=True))
        # yardstick: the backward of PyTorch's attention on the same inputs (timed only)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        dot = do.transpose(1, 2)
        library = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True))
        pairs = b * hq * s * (s + 1) / 2  # allowed causal (query, key) pairs over all q heads
        ops = 5 * 2 * pairs * d  # S, dP, dV, dK, dQ products, 2 FLOP per MAC
        n_bytes = 2 * (4 * b * s * hq * d + 4 * b * s * hkv * d) + 4 * b * hq * s  # q o do dq; k v dk dv; lse
        bound_ms, bound_by = bound(ops, n_bytes)
        log(f"  flash bwd time bf16 causal B{b} S{s}: kernel {t_k:.3f} ms ({ops / (t_k * 1e-3) / 1e12:.1f} "
            f"TFLOP/s), plain {t_p:.3f} ms, SDPA backward {library:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        rows[(b, s)] = {"max_abs_err": worst["bfloat16"], "rel_err": worst_rel["bfloat16"], "ms": t_k,
                        "plain_ms": t_p, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library}
        del q, k, v, do, o, lse, qt, kt, vt, out, dot
        torch.cuda.empty_cache()
    log(f"phase 6 flash backward: ok (rel err f32 {worst_rel['float32']:.2e}, bf16 {worst_rel['bfloat16']:.2e}; "
        f"max err f32 {worst['float32']:.3e}, bf16 {worst['bfloat16']:.3e})")
    return rows[(2, 2048)]


def phase_cross_entropy(gen, vocab: int):
    import torch
    import torch.nn.functional as F

    from ssi_tpu_torch.ops.cross_entropy import (
        cross_entropy_de,
        cross_entropy_dh,
        cross_entropy_lse,
        fused_cross_entropy,
    )
    from ssi_tpu_torch.ops.cross_entropy_cuda import (
        cross_entropy_de_kernel,
        cross_entropy_dh_kernel,
        cross_entropy_lse_kernel,
        fused_cross_entropy_kernel,
    )

    d = 2048
    # (kernel, dtype) -> worst max |err| and worst relative error over the cases
    worst, worst_rel = {}, {}

    def note(name, key, err, rel):
        worst[name, key] = max(worst.get((name, key), 0.0), err)
        worst_rel[name, key] = max(worst_rel.get((name, key), 0.0), rel)

    def inputs(n, dtype, spread=1.0):
        """h ~ N(0, spread^2) and E at init_params' scale: logits of std ``spread``."""
        h = (torch.randn((n, d), generator=gen, device="cuda") * spread).to(dtype)
        e = (torch.randn((vocab, d), generator=gen, device="cuda") * d**-0.5).to(dtype)
        y = torch.randint(0, vocab, (n,), generator=gen, device="cuda", dtype=torch.int32)
        y[::7] = -100
        return h, e, y

    g = torch.tensor(1.0, device="cuda")
    # spread 1 is the model at init (softmax near uniform, ~1/V); spread 4 is a
    # trained-like spread, where the softmax puts real mass on a few rows
    for n in (4096, 3072):  # one SFT micro-batch (2 x 2048), and a ragged count
        for dtype in (torch.float32, torch.bfloat16):
            for spread in (1.0, 4.0):
                key = str(dtype).split(".")[1]
                h, e, y = inputs(n, dtype, spread)
                what = f"cross entropy N{n} {key} spread {spread:g}"
                lse = cross_entropy_lse_kernel(h, e)
                lse_p = cross_entropy_lse(h, e)
                loss, loss_p = fused_cross_entropy_kernel(h, e, y), fused_cross_entropy(h, e, y)
                dh, dh_p = cross_entropy_dh_kernel(h, e, y, lse, g), cross_entropy_dh(h, e, y, g)
                de, de_p = cross_entropy_de_kernel(h, e, y, lse, g), cross_entropy_de(h, e, y, g)
                # control for dE: the kernel itself fed every probability 5% low (lse + 0.05)
                de_c = cross_entropy_de_kernel(h, e, y, lse + 0.05, g)
                torch.cuda.synchronize()
                valid = y != -100
                n_valid = int(valid.sum())
                # lse: absolute, against a constant lse (its mean) as the control
                err_lse = (lse - lse_p).abs().max().item()
                check(err_lse <= LSE_ATOL, f"{what} lse: max err {err_lse:.3e} > {LSE_ATOL}")
                note("cross_entropy_lse", key, err_lse, rel_err(lse, lse_p))
                spread_lse = (lse_p - lse_p.mean()).abs().max().item()
                check(spread_lse > LSE_ATOL, f"{what} lse: a constant lse passes ({spread_lse:.3e} <= {LSE_ATOL})")
                # loss: relative to the sum, against the loss of lse + 0.05 as the control
                rel_loss = abs(loss.item() - loss_p.item()) / abs(loss_p.item())
                check(rel_loss <= 1e-5, f"{what} loss: {loss.item()} vs plain {loss_p.item()} (rel {rel_loss:.2e})")
                check(0.05 * n_valid / abs(loss_p.item()) > 1e-5, f"{what} loss: the control lse + 0.05 passes")
                # dh: control drops the softmax term (keeps -g * E[label]). At spread 1
                # that term is ~0.5% of dh, inside the bf16 limit, so the control
                # applies where it can be told: f32, or spread 4
                onehot = torch.where(valid[:, None], -e[torch.where(valid, y, 0).long()].float(), 0.0) * g
                tell = dtype == torch.float32 or spread > 1.0
                err_dh, rel_dh, c_dh = hold(f"{what} dh", dh, dh_p, key,
                                            [("softmax term dropped", onehot)] if tell else [])
                note("cross_entropy_dh", key, err_dh, rel_dh)
                # dE: rows of labelled vocab entries (-g * sum of h) apart from the
                # rest, whose whole gradient is the softmax term
                labelled = torch.zeros(vocab, dtype=torch.bool, device="cuda")
                labelled[y[valid].long()] = True
                err_l, rel_l, _ = hold(f"{what} dE labelled rows", de[labelled], de_p[labelled], key)
                err_u, rel_u, c_de = hold(f"{what} dE unlabelled rows", de[~labelled], de_p[~labelled], key,
                                          [("kernel with lse + 0.05", de_c[~labelled])])
                note("cross_entropy_de", key, max(err_l, err_u), max(rel_l, rel_u))
                c_dh = f"{c_dh:.2e}" if tell else "not applied"
                log(f"  {what}: lse max err {err_lse:.2e} (limit {LSE_ATOL}; constant lse {spread_lse:.2e}); "
                    f"loss rel {rel_loss:.2e} (limit 1e-5); rel dh {rel_dh:.2e} (control {c_dh}), dE labelled "
                    f"{rel_l:.2e}, dE unlabelled {rel_u:.2e} (control {c_de:.2e}) (limit {REL[key]}); "
                    f"max|err| dh {err_dh:.2e}, dE {max(err_l, err_u):.2e}")
                del h, e, y, lse, lse_p, dh, dh_p, de, de_p, de_c, onehot, labelled
                torch.cuda.empty_cache()

    n = 4096
    h, e, y = inputs(n, torch.bfloat16)
    lse = cross_entropy_lse_kernel(h, e)
    t = {"cross_entropy_lse": in_turns(lambda: cross_entropy_lse_kernel(h, e), lambda: cross_entropy_lse(h, e), 5),
         "cross_entropy_dh": in_turns(lambda: cross_entropy_dh_kernel(h, e, y, lse, g),
                                      lambda: cross_entropy_dh(h, e, y, g), 3),
         "cross_entropy_de": in_turns(lambda: cross_entropy_de_kernel(h, e, y, lse, g),
                                      lambda: cross_entropy_de(h, e, y, g), 3)}
    # yardstick: two PyTorch calls (the logits product and cross_entropy) and their backward, timed only
    hl, el = h.detach().requires_grad_(), e.detach().requires_grad_()
    yl = y.long()
    lib_fwd = time_ms(lambda: F.cross_entropy(hl @ el.T, yl, reduction="sum"), iters=5)
    loss = F.cross_entropy(hl @ el.T, yl, reduction="sum")
    lib_bwd = time_ms(lambda: torch.autograd.grad(loss, (hl, el), retain_graph=True), iters=3)
    ops = 2 * n * vocab * d  # one logits pass; dh and dE each also form dlogits . operand
    hb, eb = 2 * n * d, 2 * vocab * d
    rows = {}
    for name, (n_ops, n_bytes, library) in {
        "cross_entropy_lse": (ops, hb + eb + 4 * n, lib_fwd),
        "cross_entropy_dh": (2 * ops, hb + eb + 8 * n + hb, lib_bwd),
        "cross_entropy_de": (2 * ops, hb + eb + 8 * n + eb, lib_bwd),
    }.items():
        bound_ms, bound_by = bound(n_ops, n_bytes)
        t_k, t_p = t[name]
        log(f"  {name} time bf16 N{n}: kernel {t_k:.3f} ms ({n_ops / (t_k * 1e-3) / 1e12:.1f} TFLOP/s), "
            f"plain {t_p:.3f} ms, bound {bound_ms:.3f} ms ({bound_by})")
        rows[name] = {"max_abs_err": worst[name, "bfloat16"], "rel_err": worst_rel[name, "bfloat16"], "ms": t_k,
                      "plain_ms": t_p, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library}
    log(f"  library yardstick N{n}: F.cross_entropy(h @ E.T) forward {lib_fwd:.3f} ms (two calls), "
        f"its backward {lib_bwd:.3f} ms (dh and dE together)")
    del h, e, y, lse, hl, el, loss
    torch.cuda.empty_cache()
    log("phase 7 cross entropy: ok (worst rel err f32 / bf16: " + ", ".join(
        f"{name.split('_')[-1]} {worst_rel[name, 'float32']:.2e} / {worst_rel[name, 'bfloat16']:.2e}"
        for name in CE_REPLACES) + ")")
    return rows


def phase_train_parity(seed: int):
    import numpy as np
    import torch

    from ssi_tpu_torch.models.llama3 import init_params
    from ssi_tpu_torch.train.optimizer import tree_leaves, tree_unflatten
    from ssi_tpu_torch.train.step import make_loss_fn

    cfg = model_config()
    params = init_params(cfg, seed=seed, dtype=torch.float32, device="cuda")
    rng = np.random.default_rng(seed + 2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 512)).astype(np.int32)).cuda()
    labels = tokens.clone()
    labels[:, :128] = -100
    out = {}
    kernel_loss = make_loss_fn(cfg, remat=False)
    for kernels in (True, False):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        tree = tree_unflatten(params, leaves)
        loss = kernel_loss(tree, tokens, labels)[0] if kernels else plain_loss(tree, tokens, labels, cfg)
        out[kernels] = (loss.detach(), torch.autograd.grad(loss, leaves))
        del leaves, tree, loss
    (l_k, g_k), (l_p, g_p) = out[True], out[False]
    rel_loss = abs(l_k.item() - l_p.item()) / abs(l_p.item())
    check(rel_loss <= 1e-4, f"f32 train parity: loss {l_k.item()} vs plain {l_p.item()}")
    worst = 0.0
    for i, (a, w) in enumerate(zip(g_k, g_p)):
        scale = w.abs().max().item()
        err = (a - w).abs().max().item() / max(scale, 1e-30)
        worst = max(worst, err)
        check(err <= 1e-4, f"f32 train parity: gradient leaf {i} differs by {err:.2e} of its largest entry")
    log(f"phase 8 f32 train parity (1B width, B1 S512): loss {l_k.item():.6f} vs plain {l_p.item():.6f} "
        f"(rel {rel_loss:.2e}); {len(g_k)} gradient leaves, worst max|diff| / max|grad| {worst:.2e}")
    del params, out, g_k, g_p
    torch.cuda.empty_cache()


def sft_window(seed: int, vocab: int, accum: int = 4, batch: int = 2, seq: int = 2048):
    """A synthetic SFT window [accum, batch, seq] from ``seed``: random tokens,
    the first quarter of each row (the prompt) labelled -100, and a padded
    tail (pad id 0, labels -100) after a row length drawn from [3/4, 1] x seq."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, vocab, (accum, batch, seq)).astype(np.int32)
    labels = tokens.copy()
    labels[..., : seq // 4] = -100
    lengths = rng.integers(3 * seq // 4, seq + 1, (accum, batch))
    tail = np.arange(seq)[None, None, :] >= lengths[..., None]
    tokens[tail] = 0
    labels[tail] = -100
    return torch.from_numpy(tokens).cuda(), torch.from_numpy(labels).cuda()


def phase_train(seed: int, smi: str):
    import torch

    from ssi_tpu_torch import _build
    from ssi_tpu_torch.models.llama3 import init_params
    from ssi_tpu_torch.train.lr_schedule import constant_schedule
    from ssi_tpu_torch.train.optimizer import AdamWConfig, init_opt_state
    from ssi_tpu_torch.train.step import make_train_step

    cfg = model_config()
    params = init_params(cfg, seed=seed, dtype=torch.bfloat16, device="cuda")
    opt = AdamWConfig()
    state = {"params": params, "opt_state": init_opt_state(params, opt), "step": 0}
    step = make_train_step(cfg, opt, constant_schedule(opt.lr), clip_grad_norm=1.0, remat="full",
                           grad_accum_dtype=torch.float32)
    tokens, labels = sft_window(seed + 3, cfg.vocab_size)
    # warm-up on the same window with every label ignored: first-use costs, and the
    # zero-token rule at full width (no update, step not advanced)
    probe = params["layers"]["wq"].clone()
    state, m = step(state, tokens, torch.full_like(labels, -100))
    torch.cuda.synchronize()
    check(not bool(m["applied"]) and state["step"] == 0 and torch.equal(params["layers"]["wq"], probe),
          "zero-token warm-up window changed the state")
    del probe
    _build.launch_counts.clear()
    losses, times, n_tok = [], [], 0
    for _ in range(3):
        t0 = time.perf_counter()
        state, m = step(state, tokens, labels)
        losses.append(float(m["loss_sum"]) / max(int(m["num_tokens"]), 1))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        n_tok = int(m["num_tokens"])
    launches = dict(_build.launch_counts)
    check(all(math.isfinite(x) for x in losses), f"non-finite training loss: {losses}")
    check(state["step"] == 3, f"step {state['step']} after 3 optimizer steps")
    check(losses[2] < losses[0], f"loss did not fall on a repeated window: {losses}")
    for name in TRAIN_KERNELS:
        check(launches.get(name, 0) > 0, f"kernel {name} was not launched on the training main path")
    mean_s = sum(times) / len(times)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"phase 9 train bf16 main path (1B, window 4 x 2 x 2048, full remat): loss per token "
        f"{', '.join(f'{x:.4f}' for x in losses)}; step ms {', '.join(f'{t * 1e3:.1f}' for t in times)} "
        f"(mean {mean_s * 1e3:.1f}); {n_tok} label tokens per step = {n_tok / mean_s:.0f} label tok/s on {smi}; "
        f"peak memory {peak:.1f} GiB; launches {launches}")
    del state, params
    torch.cuda.empty_cache()
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
    rows = {"flash_attention_fwd": phase_flash(gen), "paged_attention_fused": phase_paged(gen)}
    phase_engine_f32(args.seed)
    serve_launches = phase_engine_bf16(args.seed, smi)
    rows["flash_attention_bwd"] = phase_flash_bwd(gen)
    rows.update(phase_cross_entropy(gen, model_config().vocab_size))
    phase_train_parity(args.seed)
    train_launches = phase_train(args.seed, smi)

    sources = {"flash_attention_fwd": ("flash_attention_fwd.cu", FLASH_REPLACES),
               "paged_attention_fused": ("paged_attention.cu", PAGED_REPLACES),
               "flash_attention_bwd": ("flash_attention_bwd.cu", FLASH_BWD_REPLACES),
               **{name: ("cross_entropy.cu", where) for name, where in CE_REPLACES.items()}}
    kernels = []
    for name, (source, replaces) in sources.items():
        by_path = {"serve": serve_launches.get(name, 0), "train": train_launches.get(name, 0)}
        kernels.append({"name": name, "route": "cuda", "source": f"ssi_tpu_torch/csrc/{source}",
                        "replaces": replaces, "launches": by_path["serve"] + by_path["train"],
                        "launches_by_path": by_path, **rows[name]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
