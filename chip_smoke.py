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
3. fused paged-decode kernel (#8) vs its plain version at the 1B serving
   shape (32 slots, 8 kv heads, page 128, context 1280; ragged and inactive
   slots), and at context 16,384 (past the old design's shared-memory cap):
   attention within tolerance, two launches bitwise equal, pools bitwise
   equal except the trash row; device times (a CUDA graph of launches,
   replayed, so the host's enqueue cost is left out) as the decode step
   launches the kernel, the 16 layers' page tables in turn (no launch finds
   its pages in L2 from the one before; a rate above the card's 3.35 TB/s
   fails the run as a timing error), beside the same layer launched again
   and again, graphed and eager, with GB/s of history pages;
a. the multi-token verify kernel (#9) vs its plain version at the same
   shape, T 4 and 8, f32 and bf16: history 0, a mid-page start, spans that
   cross a page, full context less T, an inactive slot and a slot whose
   write cap cuts its span; attention within tolerance on tokens whose
   writes land, beside a control (the plain output with the in-flight
   causal mask dropped) that must miss; two launches bitwise equal; pools
   bitwise equal except the trash row; T 4 at context 16,384; times as in
   phase 3;
4. engine in f32 at the full width of ``llama3_2_1b`` (random weights from
   ``--seed``): greedy tokens identical with the kernels and with the plain
   versions, and equal to a full-recompute greedy oracle for one prompt;
b. speculation in f32 at the same width: prompts that share a 256-token
   prefix and repeat content; ``speculate_k=3`` emits the ``speculate_k=0``
   tokens, with the kernels and with the plain versions; the prefix cache
   and the drafter both engage;
5. the serving main path: the 1B bf16 engine serves 64 requests (32 slots,
   128 tokens each); every request finishes, every page is free or parked in
   the prefix cache, and both serving kernels' launch counters are > 0 for
   that run;
c. the serving path with speculation: phase 5's requests with
   ``speculate_k=3``, the prefix cache and ``prefill_chunk=512``; every
   request finishes, pages balance, the flash and verify kernels' launch
   counters are > 0; tok/s, tokens per verify step and the token agreement
   with phase 5 (bf16: the T-token verify GEMMs round unlike the 1-token
   step, so agreement is reported, not required);
6. flash-attention backward kernel vs its plain version (dq, dk, dv; f32 and
   bf16; causal, full, segment ids) at B 4, S 768 and the training shape
   B 2, S 2048, with the plain gradients at lse + 0.05 as the control; dq,
   dk and dv bitwise equal over two launches; times and TFLOP/s (counted on
   the 5 products and on the 7 the kernels issue) beside the backward of
   PyTorch's ``scaled_dot_product_attention`` (timed only, as a yardstick);
7. the cross-entropy kernels (lse, the backward's dlogits pass, the dh and
   dE GEMMs) and the loss vs their plain versions at N 4,096 and 3,072
   tokens, D 2048, V 133,258 (f32 and bf16, every 7th label ignored), at the
   init logit spread and a trained-like one (std 4); dE's labelled and
   unlabelled vocab rows held apart; controls: a constant lse, lse + 0.05,
   dh without its softmax term; lse, dh and dE bitwise equal over two
   launches;
   times of each pass and of the whole backward beside one ``torch.mm`` per
   GEMM and ``F.cross_entropy(h @ E.T, y)`` with its backward;
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

Tolerances: phases 2, 3 and a hold each output elementwise to ``TOL``
(absolute and relative). Every kernel output is also held in relative norm,
||kernel - plain|| / ||plain|| <= ``REL`` (1e-4 f32, 1e-2 bf16), and in
phases a, 6 and 7 each such check comes with a control, a deliberately wrong
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
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FLASH_REPLACES = "ssi_tpu/ops/flash_attention.py:76"  # _fwd_kernel (and _fwd_kernel_grouped, :174)
FLASH_BWD_REPLACES = "ssi_tpu/ops/flash_attention.py:263"  # _bwd_kernel (and _bwd_kernel_grouped, :365)
PAGED_REPLACES = "ssi_tpu/generate/paged_pallas.py:83"  # paged_attention_pallas -> _kernel
PAGED_MULTI_REPLACES = "ssi_tpu/generate/paged_pallas.py:425"  # paged_attention_pallas_multi -> _kernel_multi
CE_REPLACES = {
    "cross_entropy_lse": "ssi_tpu/ops/cross_entropy_pallas.py:53",  # _compute_lse -> _lse_kernel
    # the logits and dlogits that _dh_kernel (:118-126) and _de_kernel (:148-156) each form
    "cross_entropy_dlogits": "ssi_tpu/ops/cross_entropy_pallas.py:108",
    "cross_entropy_dh": "ssi_tpu/ops/cross_entropy_pallas.py:108",  # _bwd_rule -> _dh_kernel
    "cross_entropy_de": "ssi_tpu/ops/cross_entropy_pallas.py:137",  # _bwd_rule -> _de_kernel
}
TRAIN_KERNELS = ("flash_attention_fwd", "flash_attention_bwd", "cross_entropy_lse", "cross_entropy_dlogits",
                 "cross_entropy_dh", "cross_entropy_de")
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


def _kernel_name(mangled: str) -> str:
    """A mangled kernel symbol -> its name (``<length><name>`` ending in
    ``_kernel``) and up to 40 characters of its mangled template arguments."""
    for m in re.finditer(r"\d+", mangled):
        for start in range(m.start(), m.end()):  # the length may follow other digits (a hash)
            n = int(mangled[start:m.end()])
            name = mangled[m.end():m.end() + n]
            if len(name) == n and name.endswith("_kernel"):
                rest = mangled[m.end() + n:]
                return name + (rest[:40] if rest.startswith("I") else "")
    return mangled


def phase_build():
    from ssi_tpu_torch import _build

    _build.load_library()
    kernel = ""  # the kernel the ptxas lines below belong to: its name and mangled template arguments
    for ln in _build.build_log.splitlines():
        if "Compiling entry function" in ln:
            kernel = _kernel_name(ln.split("'")[1])
        elif "registers" in ln or "spill" in ln:
            log(f"  ptxas {kernel}: {ln.strip()}")
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
    # times at the checked shapes, beside one PyTorch call; the kernels line reports B8 S768
    times, library = {}, {}
    for b, s in ((8, 768), (2, 768), (2, 2048)):
        q = torch.randn((b, s, hq, d), generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
        times[(b, s)] = in_turns(lambda: flash_attention_fwd(q, k, v, causal=True),
                                 lambda: flash_attention_reference(q, k, v, causal=True))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library[(b, s)] = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True))
        # useful causal work: QK^T and PV over the S(S+1)/2 allowed pairs, 2 FLOP per MAC
        tflops = 4 * b * hq * d * s * (s + 1) / 2 / (times[(b, s)][0] * 1e-3) / 1e12
        log(f"  flash time bf16 causal B{b} S{s}: kernel {times[(b, s)][0]:.3f} ms ({tflops:.1f} TFLOP/s = "
            f"{tflops / 989:.1%} of the bf16 tensor-core peak), plain {times[(b, s)][1]:.3f} ms, "
            f"scaled_dot_product_attention {library[(b, s)]:.3f} ms")
    b, s = 8, 768
    n_bytes = 2 * (2 * b * s * hq * d + 2 * b * s * hkv * d) + 4 * b * hq * s  # q, o; k, v; lse
    bound_ms, bound_by = bound(4 * b * hq * d * s * (s + 1) / 2, n_bytes)
    log(f"  flash B8 S768: bound {bound_ms:.4f} ms ({bound_by})")
    log(f"phase 2 flash forward: ok (max err f32 {worst['float32']:.3e}, bf16 {worst['bfloat16']:.3e})")
    return {"max_abs_err": worst["bfloat16"], "ms": times[(8, 768)][0], "plain_ms": times[(8, 768)][1],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library[(8, 768)]}


HBM_GBS = PEAK_BYTES / 1e9


def paged_inputs(gen, dtype, t_q, slots, hkv, n_rep, ps, max_pages, n_layers, hist, active):
    """Pools of ``n_layers`` layers (trash row last), a random logical page
    map, q and the new K/V of #8 (``t_q`` 1) or #9, and per layer its page
    table and write rows (inactive slots write to the trash row)."""
    import torch

    n_pages = slots * max_pages
    rows = n_layers * n_pages + 1
    hd = 64
    kp = torch.randn((rows, ps, hkv * hd), generator=gen, device="cuda").to(dtype)
    vp = torch.randn((rows, ps, hkv * hd), generator=gen, device="cuda").to(dtype)
    shape = (slots,) if t_q == 1 else (slots, t_q)
    q = torch.randn((*shape, hkv * n_rep, hd), generator=gen, device="cuda").to(dtype)
    kn = torch.randn((*shape, hkv, hd), generator=gen, device="cuda").to(dtype)
    vn = torch.randn((*shape, hkv, hd), generator=gen, device="cuda").to(dtype)
    logical = torch.randperm(n_pages, generator=gen, device="cuda").view(slots, max_pages).to(torch.int32)
    pos = hist[:, None] + torch.arange(t_q, device="cuda")[None, :]
    per_layer = []
    for layer in range(n_layers):
        table = layer * n_pages + logical
        write = torch.where(active[:, None], torch.gather(table, 1, (pos // ps).clamp(max=max_pages - 1).long()),
                            rows - 1).to(torch.int32)
        per_layer.append((table, write[:, 0] if t_q == 1 else write))
    return kp, vp, q, kn, vn, per_layer


def paged_call(t_q: int):
    """(kernel, plain) of #8 (``t_q`` 1) or #9, and the lengths each takes
    from the history lengths and the active mask."""
    import torch

    from ssi_tpu_torch.generate.paged_cuda import (
        paged_attention_fused,
        paged_attention_fused_reference,
        paged_attention_multi_fused,
        paged_attention_multi_fused_reference,
    )

    if t_q == 1:  # seq_lens count the incoming token; 0 = inactive
        return (paged_attention_fused, paged_attention_fused_reference,
                lambda hist, active: torch.where(active, hist + 1, 0).to(torch.int32))
    return paged_attention_multi_fused, paged_attention_multi_fused_reference, lambda hist, active: hist


def paged_long_context(gen, t_q: int, key_dtypes=("float32", "bfloat16")) -> str:
    """#8 (``t_q`` 1) or #9 at 32 slots, context 16,384, 8 kv heads, n_rep 4,
    page 128, past the old #8's shared-memory cap: kernel vs plain (``hold``),
    two launches bitwise equal, pools bitwise equal except the trash row; the
    bf16 launch's time and GB/s (1 GB of pages: no L2 reuse). Returns a
    summary for the phase line."""
    import torch

    from ssi_tpu_torch.generate.paged_cuda import split_plan

    slots, hkv, n_rep, ps, max_pages = 32, 8, 4, 128, 128
    cap = ps * max_pages
    kernel, plain, lens_of = paged_call(t_q)
    hist = [cap - t_q, 0, 1, 1024, 1025, 6000]
    hist = torch.tensor(hist + torch.randint(1, cap - t_q + 1, (slots - len(hist),), generator=gen,
                                             device="cuda").tolist(), dtype=torch.int32, device="cuda")
    active = torch.ones(slots, dtype=torch.bool, device="cuda")
    active[1] = False
    lens = lens_of(hist, active)
    parts = []
    for key in key_dtypes:
        dtype = getattr(torch, key)
        kp, vp, q, kn, vn, ((table, write),) = paged_inputs(gen, dtype, t_q, slots, hkv, n_rep, ps, max_pages, 1,
                                                            hist, active)
        kw = dict(k_new=kn, v_new=vn, write_rows=write)
        kp_ref, vp_ref = kp.clone(), vp.clone()
        got = kernel(q, kp, vp, table, lens, **kw)
        again = kernel(q, kp, vp, table, lens, **kw)
        ref = plain(q, kp_ref, vp_ref, table, lens, **kw)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"paged T{t_q} context {cap} {key}: two launches differ")
        check(torch.equal(kp[:-1], kp_ref[:-1]) and torch.equal(vp[:-1], vp_ref[:-1]),
              f"paged T{t_q} context {cap} {key}: pools not bitwise equal outside the trash row")
        err, rel, _ = hold(f"paged T{t_q} context {cap}", got[active], ref[active], key)
        check(torch.allclose(got[active].float(), ref[active].float(), atol=TOL[key], rtol=TOL[key]),
              f"paged T{t_q} context {cap} {key}: max err {err} > tol {TOL[key]}")
        part = f"{key} rel {rel:.2e}"
        if key == "bfloat16":
            t = graph_ms([lambda: kernel(q, kp, vp, table, lens, **kw)] * 4)
            n_bytes = int(hist[active].sum().item()) * hkv * 64 * kp.element_size() * 2
            part += f", {t:.3f} ms ({n_bytes / 1e9:.2f} GB of pages, {n_bytes / (t * 1e-3) / 1e9:.0f} GB/s)"
        parts.append(part)
        del kp, vp, kp_ref, vp_ref, got, again, ref
        torch.cuda.empty_cache()
    per_split, n_splits = split_plan(max_pages, ps)
    return (f"context {cap} ({n_splits} splits of {per_split} pages; the old #8 refused it): "
            + "; ".join(parts) + "; two launches bitwise equal, pools bitwise equal except trash")


def graph_ms(calls, replays: int = 10) -> float:
    """Device time per call (ms) of ``calls``, no-argument functions that
    launch CUDA work, captured once in a CUDA graph and replayed: the host's
    cost of enqueuing a call, which exceeds a short kernel's run time, is
    left out."""
    import torch

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
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * len(calls))


def paged_times(kernel, plain, per_layer, layer, n_bytes):
    """The kernel's device time as the decode step launches it, the layers'
    page tables in turn (no launch finds its pages in L2 from the one
    before), and the plain version's alike: one CUDA graph of a launch per
    layer, replayed, in turns (plain, kernel, kernel, plain; best of each).
    Beside them, the same layer again and again, graphed, and as the earlier
    design was timed (eager launches between two events, which reads the
    host's enqueue rate once that exceeds the kernel's time). ``kernel(table, write)``;
    ``n_bytes``: the history pages one launch reads. Returns (rotated ms,
    plain ms, same-layer graphed ms, same-layer eager ms, rotated GB/s)."""
    rot_k = [lambda t=t, w=w: kernel(t, w) for t, w in per_layer]
    rot_p = [lambda t=t, w=w: plain(t, w) for t, w in per_layer]
    t_p = graph_ms(rot_p)
    t_k = min(graph_ms(rot_k), graph_ms(rot_k))
    t_p = min(t_p, graph_ms(rot_p))
    same = [lambda: kernel(*per_layer[layer])] * len(per_layer)
    t_same = graph_ms(same)
    t_eager = time_ms(same[0], 32)
    gbs = n_bytes / (t_k * 1e-3) / 1e9
    check(gbs <= HBM_GBS, f"the rotated timing reads {gbs:.0f} GB/s, above the card's {HBM_GBS:.0f}: "
          "the timing is wrong (pages served from L2)")
    return t_k, t_p, t_same, t_eager, gbs


def phase_paged(gen):
    import torch

    slots, hq, hkv, hd, ps, max_ctx, n_layers = 32, 32, 8, 64, 128, 1280, 16
    n_rep = hq // hkv
    kernel, plain, lens_of = paged_call(1)
    layer = 5
    lens = [1, ps, 2 * ps - 3, max_ctx, 0]  # 0 = inactive slot
    lens += torch.randint(1, max_ctx + 1, (slots - len(lens),), generator=gen, device="cuda").tolist()
    seq_lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    active = seq_lens > 0
    hist = (seq_lens - 1).clamp(min=0)
    worst, timing = {}, None
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype).split(".")[1]
        tol = TOL[key]
        kp, vp, q, kn, vn, per_layer = paged_inputs(gen, dtype, 1, slots, hkv, n_rep, ps, max_ctx // ps, n_layers,
                                                    hist, active)
        table, write_rows = per_layer[layer]
        kw = dict(k_new=kn, v_new=vn)
        kp_ref, vp_ref = kp.clone(), vp.clone()
        got = kernel(q, kp, vp, table, seq_lens, write_rows=write_rows, **kw)
        again = kernel(q, kp, vp, table, seq_lens, write_rows=write_rows, **kw)
        ref = plain(q, kp_ref, vp_ref, table, seq_lens, write_rows=write_rows, **kw)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"paged attention {key}: two launches differ")
        err = (got[active].float() - ref[active].float()).abs().max().item()
        check(torch.allclose(got[active].float(), ref[active].float(), atol=tol, rtol=tol),
              f"paged attention {key}: max err {err} > tol {tol}")
        _, rel, _ = hold("paged attention", got[active], ref[active], key)
        check(torch.equal(kp[:-1], kp_ref[:-1]) and torch.equal(vp[:-1], vp_ref[:-1]),
              f"paged pools {key}: not bitwise equal outside the trash row")
        worst[key] = err
        log(f"  paged {key:8s}: max|attn err| {err:.3e} (tol {tol}), rel {rel:.2e} (limit {REL[key]}); "
            "two launches bitwise equal; pools bitwise equal except trash")
        if dtype == torch.bfloat16:
            # bytes the algorithm must read: every history K and V row of every active slot
            n_tokens = int(hist[active].sum().item())
            n_bytes = n_tokens * hkv * hd * kp.element_size() * 2
            timing = paged_times(
                lambda t, w: kernel(q, kp, vp, t, seq_lens, write_rows=w, **kw),
                lambda t, w: plain(q, kp_ref, vp_ref, t, seq_lens, write_rows=w, **kw), per_layer, layer, n_bytes)
            t_k, t_p, t_same, t_eager, gbs = timing
            # bound: those pages, q read and out written, the new K/V read and written once
            bound_ms, bound_by = bound(4 * n_tokens * hq * hd,
                                       n_bytes + 2 * 2 * slots * hq * hd + 4 * 2 * slots * hkv * hd)
            log(f"  paged time bf16, 32 slots, one layer, device time of a graph of the 16 layers in turn: kernel "
                f"{t_k:.4f} ms ({n_bytes / 1e6:.1f} MB of pages, {gbs:.0f} GB/s = {gbs / HBM_GBS:.1%} of 3.35 TB/s), "
                f"plain {t_p:.3f} ms; the same layer again and again (pages partly in L2): {t_same:.4f} ms graphed, "
                f"{t_eager:.4f} ms eager (the earlier design's timing); bound {bound_ms:.4f} ms ({bound_by}); "
                "no single PyTorch call computes it")
        del kp, vp, kp_ref, vp_ref
        torch.cuda.empty_cache()
    log(f"  paged {paged_long_context(gen, 1)}")
    log(f"phase 3 paged decode: ok (max err f32 {worst['float32']:.3e}, bf16 {worst['bfloat16']:.3e})")
    t_k, t_p, t_same, t_eager, gbs = timing
    return {"max_abs_err": worst["bfloat16"], "ms": t_k, "plain_ms": t_p, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "ms_same_layer": t_same, "ms_same_layer_eager": t_eager,
            "gb_per_s": gbs}


def phase_paged_multi(gen):
    import torch

    from ssi_tpu_torch.generate.paged import paged_attention

    slots, hq, hkv, hd, ps, max_ctx, n_layers = 32, 32, 8, 64, 128, 1280, 16
    n_rep = hq // hkv
    max_pages = max_ctx // ps
    kernel, plain, _ = paged_call(4)
    layer = 9
    worst, row = {}, None
    for t_q in (4, 8):
        # history 0, a mid-page start, a span crossing a page, full context less T,
        # an inactive slot (6), a slot whose cap cuts its span (7), the rest ragged
        fixed = [0, 5, ps - 2, 3 * ps + 60, max_ctx - t_q, 700, 400, 2 * ps - 1]
        hist = fixed + torch.randint(1, max_ctx - t_q + 1, (slots - len(fixed),), generator=gen, device="cuda").tolist()
        hist = torch.tensor(hist, dtype=torch.int32, device="cuda")
        active = torch.ones(slots, dtype=torch.bool, device="cuda")
        active[6] = False
        cap = torch.full((slots,), max_ctx, dtype=torch.int32, device="cuda")
        cap[7] = 2 * ps + 1  # positions 2*ps-1 and 2*ps persist, the rest go to the trash row
        pos = hist[:, None] + torch.arange(t_q, device="cuda")[None, :]
        ok = active[:, None] & (pos < cap[:, None])
        landed = torch.cumprod(ok.int(), dim=1).bool()  # token t and every earlier one persisted
        for dtype in (torch.float32, torch.bfloat16):
            key = str(dtype).split(".")[1]
            tol = TOL[key]
            kp, vp, q, kn, vn, per_layer = paged_inputs(gen, dtype, t_q, slots, hkv, n_rep, ps, max_pages, n_layers,
                                                        hist, active)
            trash = kp.shape[0] - 1
            per_layer = [(t, torch.where(ok, w, trash).to(torch.int32)) for t, w in per_layer]
            table, write_rows = per_layer[layer]
            kw = dict(k_new=kn, v_new=vn)
            kp_ref, vp_ref = kp.clone(), vp.clone()
            got = kernel(q, kp, vp, table, hist, write_rows=write_rows, **kw)
            again = kernel(q, kp, vp, table, hist, write_rows=write_rows, **kw)
            ref = plain(q, kp_ref, vp_ref, table, hist, write_rows=write_rows, **kw)
            # control: every in-flight token sees all T (the causal mask dropped)
            loose = torch.stack([paged_attention(q[:, t], kp_ref, vp_ref, table, hist + t_q) for t in range(t_q)], 1)
            torch.cuda.synchronize()
            check(torch.equal(got, again), f"paged multi T{t_q} {key}: two launches differ")
            a, w = got[landed].float(), ref[landed].float()
            err = (a - w).abs().max().item()
            check(torch.allclose(a, w, atol=tol, rtol=tol), f"paged multi T{t_q} {key}: max err {err} > tol {tol}")
            _, rel, ctrl = hold(f"paged multi T{t_q}", got[landed], ref[landed], key,
                                [("causal mask dropped", loose[landed])])
            check(torch.equal(kp[:-1], kp_ref[:-1]) and torch.equal(vp[:-1], vp_ref[:-1]),
                  f"paged multi T{t_q} {key}: pools not bitwise equal outside the trash row")
            worst[key] = max(worst.get(key, 0.0), err)
            log(f"  paged multi T{t_q} {key:8s}: max|attn err| {err:.3e} (tol {tol}) over {int(landed.sum())} landed "
                f"tokens, rel {rel:.2e} (limit {REL[key]}; control {ctrl:.2e}); two launches bitwise equal; pools "
                "bitwise equal except trash")
            if dtype == torch.bfloat16:
                elt = kp.element_size()
                n_hist = int(hist[active].sum().item())
                n_bytes_hist = n_hist * hkv * hd * elt * 2
                t_k, t_p, t_same, t_eager, gbs = paged_times(
                    lambda t, w: kernel(q, kp, vp, t, hist, write_rows=w, **kw),
                    lambda t, w: plain(q, kp_ref, vp_ref, t, hist, write_rows=w, **kw), per_layer, layer,
                    n_bytes_hist)
                # bound: the history K and V rows of active slots, q read and out written,
                # the new K/V read once and the persisted tokens written once
                n_bytes = (n_bytes_hist + 2 * slots * t_q * hq * hd * elt + 2 * slots * t_q * hkv * hd * elt
                           + int(ok.sum().item()) * hkv * hd * elt * 2)
                n_active = int(active.sum().item())
                ops = 4 * hq * hd * (t_q * n_hist + n_active * t_q * (t_q + 1) // 2)
                bound_ms, bound_by = bound(ops, n_bytes)
                log(f"  paged multi time bf16 T{t_q}, 32 slots, one layer, device time of a graph of the 16 layers "
                    f"in turn: kernel {t_k:.4f} ms ({gbs:.0f} GB/s of history pages = {gbs / HBM_GBS:.1%} of 3.35 "
                    f"TB/s), plain {t_p:.3f} ms; the same layer again and again: {t_same:.4f} ms graphed, "
                    f"{t_eager:.4f} ms eager (the earlier design's timing); bound {bound_ms:.4f} ms "
                    f"({bound_by}); no single PyTorch call computes it")
                if t_q == 4:  # the main path's T (speculate_k=3)
                    row = {"ms": t_k, "plain_ms": t_p, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                           "ms_same_layer": t_same, "ms_same_layer_eager": t_eager, "gb_per_s": gbs}
            del kp, vp, kp_ref, vp_ref
            torch.cuda.empty_cache()
    log(f"  paged multi T4 {paged_long_context(gen, 4)}")
    log(f"phase a paged multi-token verify: ok (max err f32 {worst['float32']:.3e}, bf16 {worst['bfloat16']:.3e})")
    return {"max_abs_err": worst["bfloat16"], **row}


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


def phase_spec_f32(seed: int):
    import numpy as np
    import torch

    from ssi_tpu_torch.generate.engine import SamplingParams
    from ssi_tpu_torch.generate.paged_engine import PagedDecodeEngine
    from ssi_tpu_torch.models.llama3 import init_params

    cfg = model_config()
    params = init_params(cfg, seed=seed, dtype=torch.float32, device="cuda")
    rng = np.random.default_rng(seed + 4)
    prefix = rng.integers(0, cfg.vocab_size, 256).tolist()
    # a shared 256-token prefix (two cacheable pages), then content said twice
    prompts = []
    for n in (40, 64, 90, 120):
        part = rng.integers(0, cfg.vocab_size, n).tolist()
        prompts.append(prefix + part + part)
    sp = SamplingParams(temperature=0.0, max_tokens=32)
    outs, stats = {}, {}
    for impl in ("kernel", "reference"):
        for k in (0, 3):
            eng = PagedDecodeEngine(params, cfg, pad_id=0, n_slots=4, attn_impl=impl, speculate_k=k)
            outs[impl, k] = [o["token_ids"] for o in eng.generate_batch(prompts, sp)]
            stats[impl, k] = dict(eng.last_stats)
            del eng
    for impl in ("kernel", "reference"):
        check(outs[impl, 3] == outs[impl, 0], f"f32 spec ({impl}): speculate_k=3 tokens differ from speculate_k=0")
        st = stats[impl, 3]
        check(st["cached_prompt_tokens"] > 0 and st["verify_steps"] > 0,
              f"f32 spec ({impl}): cached_prompt_tokens {st['cached_prompt_tokens']}, verify_steps {st['verify_steps']}")
    check(outs["kernel", 3] == outs["reference", 3], "f32 spec: kernel and plain tokens differ")
    st = stats["kernel", 3]
    log(f"phase b spec f32 (1B width): 4 prompts (256-token shared prefix, repeated content) x 32 greedy tokens "
        f"identical for speculate_k 3 and 0, kernels and plain; cached prompt tokens {st['cached_prompt_tokens']}, "
        f"verify steps {st['verify_steps']}, tokens per verify {st['tokens_per_verify']:.3f}")
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
    parked = len(eng._free_pages) + len(eng._cache_lru)
    check(parked == eng.n_pages, f"pages leaked: {eng.n_pages - parked}")
    for name in ("flash_attention_fwd", "paged_attention_fused"):
        check(launches.get(name, 0) > 0, f"kernel {name} was not launched on the main path")
    n_tok = sum(len(o["token_ids"]) for o in outs)
    s = eng.last_stats
    log(f"phase 5 engine bf16 main path: 64 requests x 128 tokens, {n_tok} tokens in {wall:.2f} s = "
        f"{n_tok / wall:.0f} generated tok/s on {smi} (wall clock incl. prefill, after a warm-up batch; "
        f"{s['chunk_dispatches']} chunks, "
        f"{s['prefill_dispatches']} prefill dispatches, occupancy {s['slot_occupancy']:.3f}); launches {launches}")
    return launches, [o["token_ids"] for o in outs], n_tok / wall


def phase_spec_serving(seed: int, smi: str, base_tokens, base_rate: float):
    import torch

    from ssi_tpu_torch import _build
    from ssi_tpu_torch.generate.engine import SamplingParams
    from ssi_tpu_torch.generate.paged_engine import PagedDecodeEngine
    from ssi_tpu_torch.models.llama3 import init_params

    cfg = model_config()
    params = init_params(cfg, seed=seed, dtype=torch.bfloat16, device="cuda")
    prompts = prompts_from_seed(seed + 1, 64, cfg.vocab_size)
    eng = PagedDecodeEngine(params, cfg, pad_id=0, n_slots=32, page_size=128, prompt_bucket=128, chunk=16,
                            speculate_k=3, prefill_chunk=512)
    check(eng.attn_impl == "kernel" and eng.prefix_caching, "spec engine: not the kernels with the prefix cache")
    eng.generate_batch(prompts_from_seed(seed + 5, 8, cfg.vocab_size), SamplingParams(max_tokens=16))  # warm-up
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    t0 = time.perf_counter()
    outs = eng.generate_batch(prompts, SamplingParams(temperature=0.0, max_tokens=128))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    for i, o in enumerate(outs):
        check(o["finish_reason"] == "length" and len(o["token_ids"]) == 128,
              f"spec request {i}: {o['finish_reason']}, {len(o['token_ids'])} tokens")
        check(all(0 <= t < cfg.vocab_size for t in o["token_ids"]), f"spec request {i}: token out of vocab")
    parked = len(eng._free_pages) + len(eng._cache_lru)
    check(parked == eng.n_pages, f"spec serving: pages leaked: {eng.n_pages - parked}")
    for name in ("flash_attention_fwd", "paged_attention_multi"):
        check(launches.get(name, 0) > 0, f"kernel {name} was not launched on the speculative serving path")
    s = eng.last_stats
    same = sum(o["token_ids"] == b for o, b in zip(outs, base_tokens))
    agree = [next((i for i, (x, y) in enumerate(zip(o["token_ids"], b)) if x != y), len(b))
             for o, b in zip(outs, base_tokens)]
    n_tok = sum(len(o["token_ids"]) for o in outs)
    log(f"phase c spec serving bf16 (speculate_k 3, prefix cache, prefill_chunk 512): 64 requests x 128 tokens, "
        f"{n_tok} tokens in {wall:.2f} s = {n_tok / wall:.0f} generated tok/s (phase 5, k=0: {base_rate:.0f}) on "
        f"{smi}; tokens per verify {s['tokens_per_verify']:.3f}, {s['verify_steps']} verify steps, "
        f"{s['chunk_dispatches']} chunks, {s['prefill_dispatches']} prefill dispatches ({s['prefill_pieces']} "
        f"chunked pieces), cached prompt tokens {s['cached_prompt_tokens']}; {same}/64 requests equal to phase 5's "
        f"tokens, mean agreeing prefix {sum(agree) / len(agree):.1f} of 128; launches {launches}")
    del eng, params
    torch.cuda.empty_cache()
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
                # no atomics: a second launch gives the same bits
                again = flash_attention_bwd(q, k, v, o, lse, do, causal=causal, segment_ids=segs)
                want = flash_attention_bwd_reference(q, k, v, o, lse, do, causal=causal, segment_ids=segs)
                # control: the plain gradients with every probability 5% low (lse + 0.05)
                ctrl = flash_attention_bwd_reference(q, k, v, o, lse + 0.05, do, causal=causal, segment_ids=segs)
                torch.cuda.synchronize()
                errs, rels, least = [], [], math.inf
                for gname, a, w, c, a2 in zip(("dq", "dk", "dv"), got, want, ctrl, again):
                    check(a.dtype == dtype, f"flash bwd {gname} dtype {a.dtype} != {dtype}")
                    check(torch.equal(a, a2), f"flash bwd {name} B{b} S{s} {key} {gname}: two launches differ")
                    err, rel, rc = hold(f"flash bwd {name} B{b} S{s} {gname}", a, w, key, [("p x 0.95", c)])
                    errs.append(err)
                    rels.append(rel)
                    least = min(least, rc)
                worst[key] = max(worst.get(key, 0.0), *errs)
                worst_rel[key] = max(worst_rel.get(key, 0.0), *rels)
                log(f"  flash bwd {name:8s} B{b} S{s} {key:8s}: rel dq {rels[0]:.2e}, dk {rels[1]:.2e}, "
                    f"dv {rels[2]:.2e} (limit {REL[key]}; control p x 0.95 >= {least:.2e}); max|err| dq {errs[0]:.3e}, "
                    f"dk {errs[1]:.3e}, dv {errs[2]:.3e}; bitwise equal over two launches")
                del o, lse, got, again, want, ctrl
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
        issued = 7 * 2 * pairs * d  # the kernels form S and dP twice (dk/dv and dq): no atomics
        n_bytes = 2 * (4 * b * s * hq * d + 4 * b * s * hkv * d) + 4 * b * hq * s  # q o do dq; k v dk dv; lse
        bound_ms, bound_by = bound(ops, n_bytes)
        log(f"  flash bwd time bf16 causal B{b} S{s}: kernel {t_k:.3f} ms ({ops / (t_k * 1e-3) / 1e12:.1f} "
            f"TFLOP/s counted on the 5 products, {issued / (t_k * 1e-3) / 1e12:.1f} issued on 7), plain {t_p:.3f} "
            f"ms, SDPA backward {library:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
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
        cross_entropy_de_gemm,
        cross_entropy_dh,
        cross_entropy_dh_gemm,
        cross_entropy_dlogits,
        cross_entropy_lse,
        fused_cross_entropy,
    )
    from ssi_tpu_torch.ops.cross_entropy_cuda import (
        cross_entropy_de_gemm_kernel,
        cross_entropy_de_kernel,
        cross_entropy_dh_gemm_kernel,
        cross_entropy_dh_kernel,
        cross_entropy_dlogits_kernel,
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
                check(torch.equal(cross_entropy_lse_kernel(h, e), lse), f"{what} lse: two launches differ")
                lse_p = cross_entropy_lse(h, e)
                loss, loss_p = fused_cross_entropy_kernel(h, e, y), fused_cross_entropy(h, e, y)
                dl = cross_entropy_dlogits_kernel(h, e, y, lse, g)
                err_dl, rel_dl, _ = hold(f"{what} dlogits", dl, cross_entropy_dlogits(h, e, y, g), key)
                note("cross_entropy_dlogits", key, err_dl, rel_dl)
                del dl
                dh, dh_p = cross_entropy_dh_kernel(h, e, y, lse, g), cross_entropy_dh(h, e, y, g)
                de, de_p = cross_entropy_de_kernel(h, e, y, lse, g), cross_entropy_de(h, e, y, g)
                # no atomics: a second launch of each gradient gives the same bits
                check(torch.equal(cross_entropy_dh_kernel(h, e, y, lse, g), dh), f"{what} dh: two launches differ")
                check(torch.equal(cross_entropy_de_kernel(h, e, y, lse, g), de), f"{what} dE: two launches differ")
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
                    f"loss rel {rel_loss:.2e} (limit 1e-5); rel dlogits {rel_dl:.2e}, dh {rel_dh:.2e} (control "
                    f"{c_dh}), dE labelled {rel_l:.2e}, dE unlabelled {rel_u:.2e} (control {c_de:.2e}) (limit "
                    f"{REL[key]}); max|err| dh {err_dh:.2e}, dE {max(err_l, err_u):.2e}; lse, dh and dE bitwise "
                    "equal over two launches")
                del h, e, y, lse, lse_p, dh, dh_p, de, de_p, de_c, onehot, labelled
                torch.cuda.empty_cache()

    n = 4096
    h, e, y = inputs(n, torch.bfloat16)
    lse = cross_entropy_lse_kernel(h, e)
    dl = cross_entropy_dlogits_kernel(h, e, y, lse, g)

    def backward():  # the kernels' whole backward, as _CrossEntropyKernel.backward runs it
        dlogits = cross_entropy_dlogits_kernel(h, e, y, lse, g)
        return cross_entropy_dh_gemm_kernel(dlogits, e), cross_entropy_de_gemm_kernel(dlogits, h)

    t = {"cross_entropy_lse": in_turns(lambda: cross_entropy_lse_kernel(h, e), lambda: cross_entropy_lse(h, e), 5),
         "cross_entropy_dlogits": in_turns(lambda: cross_entropy_dlogits_kernel(h, e, y, lse, g),
                                           lambda: cross_entropy_dlogits(h, e, y, g), 3),
         "cross_entropy_dh": in_turns(lambda: cross_entropy_dh_gemm_kernel(dl, e),
                                      lambda: cross_entropy_dh_gemm(dl, e), 3),
         "cross_entropy_de": in_turns(lambda: cross_entropy_de_gemm_kernel(dl, h),
                                      lambda: cross_entropy_de_gemm(dl, h), 3)}
    t_bwd, t_bwd_p = in_turns(backward, lambda: (cross_entropy_dh(h, e, y, g), cross_entropy_de(h, e, y, g)), 3)
    # yardsticks, timed only: one PyTorch call for each GEMM; the logits product and
    # cross_entropy (two calls) and their backward
    lib_dh = time_ms(lambda: torch.mm(dl, e, out_dtype=torch.float32), iters=3)
    lib_de = time_ms(lambda: torch.mm(dl.t(), h, out_dtype=torch.float32), iters=3)
    hl, el = h.detach().requires_grad_(), e.detach().requires_grad_()
    yl = y.long()
    lib_fwd = time_ms(lambda: F.cross_entropy(hl @ el.T, yl, reduction="sum"), iters=5)
    loss = F.cross_entropy(hl @ el.T, yl, reduction="sum")
    lib_bwd = time_ms(lambda: torch.autograd.grad(loss, (hl, el), retain_graph=True), iters=3)
    ops = 2 * n * vocab * d  # one [N, D] x [D, V] product
    hb, eb, dlb = 2 * n * d, 2 * vocab * d, 2 * n * vocab
    rows = {}
    for name, (n_bytes, library) in {
        "cross_entropy_lse": (hb + eb + 4 * n, lib_fwd),
        "cross_entropy_dlogits": (hb + eb + 8 * n + dlb, None),  # h, E, lse, labels read; dlogits written
        "cross_entropy_dh": (dlb + eb + hb, lib_dh),
        "cross_entropy_de": (dlb + hb + eb, lib_de),
    }.items():
        bound_ms, bound_by = bound(ops, n_bytes)
        t_k, t_p = t[name]
        log(f"  {name} time bf16 N{n}: kernel {t_k:.3f} ms ({ops / (t_k * 1e-3) / 1e12:.1f} TFLOP/s), "
            f"plain {t_p:.3f} ms, bound {bound_ms:.3f} ms ({bound_by})"
            + (f", one PyTorch call {library:.3f} ms" if name != "cross_entropy_lse" and library is not None else "")
            + (f", F.cross_entropy(h @ E.T) {library:.3f} ms (two calls)" if name == "cross_entropy_lse" else ""))
        rows[name] = {"max_abs_err": worst[name, "bfloat16"], "rel_err": worst_rel[name, "bfloat16"], "ms": t_k,
                      "plain_ms": t_p, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library}
    bound_bwd, by_bwd = bound(3 * ops, hb + eb + 8 * n + hb + eb)  # h, E, lse, labels read; dh, dE written
    log(f"  cross-entropy backward bf16 N{n} (dlogits + dh + dE): kernels {t_bwd:.3f} ms "
        f"({3 * ops / (t_bwd * 1e-3) / 1e12:.1f} TFLOP/s), plain {t_bwd_p:.3f} ms, bound {bound_bwd:.3f} ms "
        f"({by_bwd}); library backward of h @ E.T + F.cross_entropy {lib_bwd:.3f} ms")
    log(f"  library yardstick N{n}: F.cross_entropy(h @ E.T) forward {lib_fwd:.3f} ms (two calls), "
        f"its backward {lib_bwd:.3f} ms (dh and dE together)")
    del h, e, y, lse, dl, hl, el, loss
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
    rows = {"flash_attention_fwd": phase_flash(gen), "paged_attention_fused": phase_paged(gen),
            "paged_attention_multi": phase_paged_multi(gen)}
    phase_engine_f32(args.seed)
    phase_spec_f32(args.seed)
    serve_launches, base_tokens, base_rate = phase_engine_bf16(args.seed, smi)
    spec_launches = phase_spec_serving(args.seed, smi, base_tokens, base_rate)
    rows["flash_attention_bwd"] = phase_flash_bwd(gen)
    rows.update(phase_cross_entropy(gen, model_config().vocab_size))
    phase_train_parity(args.seed)
    train_launches = phase_train(args.seed, smi)

    sources = {"flash_attention_fwd": ("flash_attention_fwd.cu", FLASH_REPLACES),
               "paged_attention_fused": ("paged_attention.cu", PAGED_REPLACES),
               "paged_attention_multi": ("paged_attention.cu", PAGED_MULTI_REPLACES),
               "flash_attention_bwd": ("flash_attention_bwd.cu", FLASH_BWD_REPLACES),
               **{name: ("cross_entropy.cu", where) for name, where in CE_REPLACES.items()}}
    kernels = []
    for name, (source, replaces) in sources.items():
        by_path = {"serve": serve_launches.get(name, 0), "spec_serve": spec_launches.get(name, 0),
                   "train": train_launches.get(name, 0)}
        kernels.append({"name": name, "route": "cuda", "source": f"ssi_tpu_torch/csrc/{source}",
                        "replaces": replaces, "launches": sum(by_path.values()),
                        "launches_by_path": by_path, **rows[name]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
