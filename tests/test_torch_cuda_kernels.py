"""The port's CUDA kernels against their plain versions on a CUDA card, at
small and odd shapes the chip smoke does not cover (ragged last q or key
tile, every GQA ratio, head_dim 64 and 128, odd vocab, ignored rows, f32
and bf16), and a small train step with the kernels against the same step
with the plain versions.
These need the card: they skip on a CPU-only machine and run on the GPU with
``python -m pytest -m cuda tests/test_torch_cuda_kernels.py``."""

import pytest
import torch

from ssi_tpu_torch import _build
from ssi_tpu_torch.generate.paged import paged_attention
from ssi_tpu_torch.generate.paged_cuda import (
    SPLIT_KEYS,
    paged_attention_fused,
    paged_attention_fused_reference,
    paged_attention_multi_fused,
    paged_attention_multi_fused_reference,
    split_plan,
)
from ssi_tpu_torch.ops.cross_entropy import (
    cross_entropy_de,
    cross_entropy_dh,
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
    cross_entropy_lse_merge_kernel,
    fused_cross_entropy_kernel,
)
from ssi_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_fwd,
    flash_attention_reference,
)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture()
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


HEADS = [(8, 8), (8, 4), (8, 2), (8, 1), (32, 8), (6, 2), (24, 8)]  # n_rep 1, 2, 4, 8, 4, 3, 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hq,hkv", HEADS)
@pytest.mark.parametrize("s,causal,segs", [(77, True, False), (200, False, False), (130, True, True),
                                           (200, False, True), (77, True, True)])
def test_flash_kernel_matches_plain(gen, dtype, d, hq, hkv, s, causal, segs):
    q = torch.randn((2, s, hq, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((2, s, hkv, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((2, s, hkv, d), generator=gen, device="cuda").to(dtype)
    seg = None
    if segs:
        seg = torch.zeros((2, s), dtype=torch.int32, device="cuda")
        seg[:, s // 3:] = 1
        seg[1, 2 * s // 3:] = 2
    before = _build.launch_counts["flash_attention_fwd"]
    o, lse = flash_attention_fwd(q, k, v, causal=causal, segment_ids=seg)
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_attention_fwd"] == before + 1
    o_ref, lse_ref = flash_attention_reference(q, k, v, causal=causal, segment_ids=seg)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=TOL[dtype], rtol=TOL[dtype])
    torch.testing.assert_close(lse, lse_ref, atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("n_rep", [1, 2, 3, 4, 8])
def test_paged_kernel_matches_plain(gen, dtype, hd, n_rep):
    slots, hkv, ps, max_pages, n_pages = 6, 2, 16, 5, 40
    rows = 2 * n_pages + 1
    kp = torch.randn((rows, ps, hkv * hd), generator=gen, device="cuda").to(dtype)
    vp = torch.randn((rows, ps, hkv * hd), generator=gen, device="cuda").to(dtype)
    q = torch.randn((slots, hkv * n_rep, hd), generator=gen, device="cuda").to(dtype)
    kn = torch.randn((slots, hkv, hd), generator=gen, device="cuda").to(dtype)
    vn = torch.randn((slots, hkv, hd), generator=gen, device="cuda").to(dtype)
    table = (n_pages + torch.randperm(n_pages, generator=gen, device="cuda")[: slots * max_pages]).view(slots, max_pages)
    seq_lens = torch.tensor([1, ps, ps + 1, 3 * ps - 5, max_pages * ps, 0], dtype=torch.int32, device="cuda")
    active = seq_lens > 0
    hist = (seq_lens - 1).clamp(min=0)
    write_rows = torch.where(active, torch.gather(table, 1, (hist // ps)[:, None].long())[:, 0], rows - 1).to(torch.int32)
    table = table.to(torch.int32)
    kp_ref, vp_ref = kp.clone(), vp.clone()
    got = paged_attention_fused(q, kp, vp, table, seq_lens, k_new=kn, v_new=vn, write_rows=write_rows)
    ref = paged_attention_fused_reference(q, kp_ref, vp_ref, table, seq_lens, k_new=kn, v_new=vn,
                                          write_rows=write_rows)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[active].float(), ref[active].float(), atol=TOL[dtype], rtol=TOL[dtype])
    assert torch.equal(kp[:-1], kp_ref[:-1]) and torch.equal(vp[:-1], vp_ref[:-1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("n_rep,t_q", [(1, 2), (2, 2), (4, 2), (4, 3), (2, 8), (4, 4), (8, 4), (8, 8),
                                       (3, 4), (3, 8), (3, 2)])
def test_paged_multi_kernel_matches_plain(gen, dtype, hd, n_rep, t_q):
    """Kernel #9 against its plain version: ragged history (0, mid-page,
    page-crossing spans, more than one 64-key tile, full context less T), an
    inactive slot, and a slot whose write cap cuts the span. Attention is
    compared on tokens whose own and earlier writes land; pools bitwise
    except the trash row."""
    slots, hkv, ps, max_pages, n_pages = 7, 2, 16, 10, 80
    rows = 2 * n_pages + 1
    trash = rows - 1
    kp = torch.randn((rows, ps, hkv * hd), generator=gen, device="cuda").to(dtype)
    vp = torch.randn((rows, ps, hkv * hd), generator=gen, device="cuda").to(dtype)
    q = torch.randn((slots, t_q, hkv * n_rep, hd), generator=gen, device="cuda").to(dtype)
    kn = torch.randn((slots, t_q, hkv, hd), generator=gen, device="cuda").to(dtype)
    vn = torch.randn((slots, t_q, hkv, hd), generator=gen, device="cuda").to(dtype)
    table = (n_pages + torch.randperm(n_pages, generator=gen, device="cuda")[: slots * max_pages]).view(slots, max_pages)
    hist = torch.tensor([0, 5, ps - 1, 3 * ps + 7, max_pages * ps - t_q, 9, 70], dtype=torch.int32, device="cuda")
    active = torch.tensor([True] * 5 + [False, True], device="cuda")
    cap = torch.full((slots,), max_pages * ps, dtype=torch.int32, device="cuda")
    cap[6] = 71  # the last slot's cap cuts its span after one token
    pos = hist[:, None] + torch.arange(t_q, device="cuda")[None, :]
    ok = active[:, None] & (pos < cap[:, None])
    logical = torch.gather(table, 1, (pos // ps).clamp(max=max_pages - 1).long())
    write_rows = torch.where(ok, logical, torch.full_like(logical, trash)).to(torch.int32)
    table = table.to(torch.int32)
    kp_ref, vp_ref = kp.clone(), vp.clone()
    got = paged_attention_multi_fused(q, kp, vp, table, hist, k_new=kn, v_new=vn, write_rows=write_rows)
    ref = paged_attention_multi_fused_reference(q, kp_ref, vp_ref, table, hist, k_new=kn, v_new=vn,
                                                write_rows=write_rows)
    torch.cuda.synchronize()
    landed = torch.cumprod(ok.int(), dim=1).bool()  # token t and every earlier token persisted
    torch.testing.assert_close(got[landed].float(), ref[landed].float(), atol=TOL[dtype], rtol=TOL[dtype])
    assert torch.equal(kp[:-1], kp_ref[:-1]) and torch.equal(vp[:-1], vp_ref[:-1])
    # control: the plain output with the in-flight causal mask dropped (every token sees all T) must miss
    loose = torch.stack([paged_attention(q[:, t], kp_ref, vp_ref, table, hist + t_q) for t in range(t_q)], dim=1)
    assert not torch.allclose(got[landed].float(), loose[landed].float(), atol=TOL[dtype], rtol=TOL[dtype])


POISON = (float("nan"), float("inf"), float("-inf"))


def check_paged_kernel(gen, dtype, t_q, n_rep, ps, max_pages, hist, active, hkv=2, hd=64, poison=False):
    """One of the paged kernels, #8 (``t_q`` 1: seq_lens = hist + 1, 0 when
    inactive) or #9, against its plain version on slots of history ``hist``
    (positions < hist_len; inactive slots write to the trash row): attention
    of active slots within tolerance, beside a control that must miss it
    (each q head routed to the next kv head; with one kv head, to the next q
    head's query), two launches bitwise equal (the
    second rewrites the same cells, which no launch reads), pools bitwise
    equal except the trash row. ``poison``: every pool cell outside the
    slots' histories holds NaN, +Inf or -Inf in the kernel's pools (the bf16
    kernel's page boxes bring such cells in) and 0 in the plain version's,
    which computes 0 * v for masked keys."""
    slots = len(hist)
    n_pages = slots * max_pages
    rows = 2 * n_pages + 1  # layer 1's pages, the trash row last
    kp = torch.randn((rows, ps, hkv * hd), generator=gen, device="cuda").to(dtype)
    vp = torch.randn((rows, ps, hkv * hd), generator=gen, device="cuda").to(dtype)
    table = (n_pages + torch.randperm(n_pages, generator=gen, device="cuda")).view(slots, max_pages).to(torch.int32)
    hist = torch.tensor(hist, dtype=torch.int32, device="cuda")
    active = torch.tensor(active, device="cuda")
    shape = (slots,) if t_q == 1 else (slots, t_q)
    q = torch.randn((*shape, hkv * n_rep, hd), generator=gen, device="cuda").to(dtype)
    kn = torch.randn((*shape, hkv, hd), generator=gen, device="cuda").to(dtype)
    vn = torch.randn((*shape, hkv, hd), generator=gen, device="cuda").to(dtype)
    pos = hist[:, None] + torch.arange(t_q, device="cuda")[None, :]
    write_rows = torch.where(active[:, None], torch.gather(table, 1, (pos // ps).long()), rows - 1).to(torch.int32)
    kw = dict(k_new=kn, v_new=vn, write_rows=write_rows[:, 0] if t_q == 1 else write_rows)
    if t_q == 1:
        lens = torch.where(active, hist + 1, 0).to(torch.int32)
        kernel, plain = paged_attention_fused, paged_attention_fused_reference
    else:
        lens = hist
        kernel, plain = paged_attention_multi_fused, paged_attention_multi_fused_reference
    unused = torch.ones((rows, ps), dtype=torch.bool, device="cuda")
    if poison:  # the history cells (position < hist_len of each slot) are the only ones read
        key = torch.arange(max_pages * ps, device="cuda")
        in_hist = key[None, :] < hist[:, None]
        unused[table[:, key // ps].long()[in_hist], (key % ps).expand(slots, -1)[in_hist]] = False
        for pool in (kp, vp):
            pool[unused] = 0
    kp_ref, vp_ref = kp.clone(), vp.clone()
    kp_ctl, vp_ctl = kp.clone(), vp.clone()
    if poison:
        cells = torch.randint(0, len(POISON), (int(unused.sum()), hkv * hd), generator=gen, device="cuda")
        for pool in (kp, vp):
            pool[unused] = torch.tensor(POISON, device="cuda")[cells].to(dtype)
    got = kernel(q, kp, vp, table, lens, **kw)
    again = kernel(q, kp, vp, table, lens, **kw)
    ref = plain(q, kp_ref, vp_ref, table, lens, **kw)
    # each q head routed to the next kv head (with one kv head: to the next q head's query)
    ctl = plain(q.roll(n_rep if hkv > 1 else 1, -2), kp_ctl, vp_ctl, table, lens, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got[active].float(), ref[active].float(), atol=TOL[dtype], rtol=TOL[dtype])
    assert not torch.allclose(got[active].float(), ctl[active].float(), atol=TOL[dtype], rtol=TOL[dtype])
    for pool, pool_ref in ((kp, kp_ref), (vp, vp_ref)):  # the poisoned cells not written read as 0
        assert torch.equal(torch.nan_to_num(pool[:-1], nan=0.0, posinf=0.0, neginf=0.0), pool_ref[:-1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
# #8 and #9 at head_dim 64 (8 x 8: two row groups) and 128 (one m16 tile a block: 8 x 3 and 8 x 4 take two
# row groups, 8 x 8 four)
@pytest.mark.parametrize("hd,t_q,n_rep", [(64, 1, 4), (64, 1, 8), (64, 4, 4), (64, 8, 4), (64, 8, 8),
                                          (128, 1, 3), (128, 1, 4), (128, 4, 3), (128, 4, 4), (128, 8, 3),
                                          (128, 8, 8)])
@pytest.mark.parametrize("ps", [16, 128])
def test_paged_kernels_split_boundaries(gen, dtype, hd, t_q, n_rep, ps):
    """The split-context kernels where splits start and end: histories that
    end exactly on a split boundary and one key past it, one that fits in one
    split (finished by that split alone), history 0 (the only live split
    holds no history key), an inactive slot, and the full context less T;
    a table of three splits."""
    max_pages = 3 * SPLIT_KEYS // ps
    per_split, n_splits = split_plan(max_pages, ps)
    sk, cap = per_split * ps, max_pages * ps
    assert n_splits == 3
    hist = [0, 100, sk - 1, sk, sk + 1, 2 * sk, 2 * sk + 1, cap - t_q, 0, 37]
    active = [True] * 8 + [False, True]
    check_paged_kernel(gen, dtype, t_q, n_rep, ps, max_pages, hist, active, hd=hd)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_at_the_drives_decode_shape(gen, dtype):
    """#8 at the 100m WER drive's decode shape: 48 slots, 4 kv heads, n_rep 2
    (8 q heads), page 128, 3 pages per slot (the drive's ~120-token prompts
    plus 256 new tokens), ragged histories and inactive slots."""
    slots, max_pages, ps = 48, 3, 128
    hist = torch.randint(0, max_pages * ps, (slots,), generator=gen, device="cuda").tolist()
    hist[:4] = [0, ps - 1, ps, max_pages * ps - 1]
    active = [i % 11 != 5 for i in range(slots)]
    check_paged_kernel(gen, dtype, 1, 2, ps, max_pages, hist, active, hkv=4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t_q", [1, 4])
@pytest.mark.parametrize("hd,n_rep", [(64, 4), (128, 3), (128, 4)])  # 1B; 3B; 8B
def test_paged_kernels_past_the_old_context_cap(gen, dtype, t_q, hd, n_rep):
    """32 slots at context 16,384: the old #8 kept every score in shared
    memory and its wrapper refused this shape; the split plan cuts it into
    13 splits of 1,280 keys."""
    ps, max_pages = 128, 128
    cap = ps * max_pages
    assert split_plan(max_pages, ps) == (10, 13)
    hist = [cap - t_q, 0, 1, 1024, 1025] + torch.randint(1, cap - t_q + 1, (27,), generator=gen, device="cuda").tolist()
    check_paged_kernel(gen, dtype, t_q, n_rep, ps, max_pages, hist, [True] * 32, hd=hd)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("poison", [False, True])
@pytest.mark.parametrize("ps", [8, 16, 64, 128, 256])
# #8 and #9 at the 1B, 3B and 8B head layouts; R 64 at head_dim 128 (T 8 x n_rep 8) in one block
@pytest.mark.parametrize("hd,t_q,n_rep", [(64, 1, 4), (64, 4, 4), (64, 8, 8), (128, 1, 3), (128, 4, 4),
                                          (128, 8, 8)])
def test_paged_kernels_page_sizes_and_unused_cells(gen, dtype, poison, ps, hd, t_q, n_rep):
    """Page sizes below a 64-key tile (a tile spans pages: one TMA box a
    page), equal to it, and above it (a page spans tiles); histories of 0
    and 1, ending on page and split boundaries and one key either side, the
    full context less T, and an inactive slot; with every cell outside the
    histories holding NaN or +-Inf, which the kernel's boxes read and must
    keep out of the output."""
    max_pages = 3 * SPLIT_KEYS // ps
    per_split, n_splits = split_plan(max_pages, ps)
    sk, cap = per_split * ps, max_pages * ps
    assert n_splits == 3
    hist = [0, 1, ps - 1, ps, ps + 1, sk - 1, sk, sk + 1, 2 * sk, cap - t_q, 100, 37]
    active = [True] * 10 + [False, True]
    check_paged_kernel(gen, dtype, t_q, n_rep, ps, max_pages, hist, active, hd=hd, poison=poison)


def test_kernel_wrappers_refuse_unsupported_shapes(gen):
    """The shapes the kernels do not take raise, naming what is still to port
    (ROADMAP B1: a head_dim above 256 in #1-#4; B2: one above 256 in
    #8/#9), or what the caller must change (T, page size)."""
    q = torch.randn((1, 16, 4, 264), generator=gen, device="cuda")
    with pytest.raises(ValueError, match=r"head_dim <= 256, got 264 \(ROADMAP.md B1"):
        flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError, match=r"head_dim <= 256, got 264 \(ROADMAP.md B1"):
        flash_attention_bwd(q, q, q, q, torch.zeros((1, 4, 16), device="cuda"), q)
    for hd in (264, 300):  # above 256, a multiple of 8 and not
        pool = torch.zeros((3, 8, 2 * hd), device="cuda")
        with pytest.raises(ValueError, match=rf"head_dim <= 256, got {hd} \(ROADMAP.md B2"):
            paged_attention_fused(
                torch.zeros((1, 4, hd), device="cuda"), pool, pool.clone(),
                torch.zeros((1, 1), dtype=torch.int32, device="cuda"), torch.ones(1, dtype=torch.int32, device="cuda"),
                k_new=torch.zeros((1, 2, hd), device="cuda"), v_new=torch.zeros((1, 2, hd), device="cuda"),
                write_rows=torch.zeros(1, dtype=torch.int32, device="cuda"),
            )
    z = torch.zeros((1, 9, 8, 64), device="cuda")
    kv9 = torch.zeros((1, 9, 2, 64), device="cuda")
    pool = torch.zeros((3, 8, 2 * 64), device="cuda")
    args = (torch.zeros((1, 1), dtype=torch.int32, device="cuda"), torch.ones(1, dtype=torch.int32, device="cuda"))
    with pytest.raises(ValueError, match=r"T \(9\)"):
        paged_attention_multi_fused(z, pool, pool.clone(), *args, k_new=kv9, v_new=kv9,
                                    write_rows=torch.zeros((1, 9), dtype=torch.int32, device="cuda"))
    pool12 = torch.zeros((3, 12, 2 * 64), device="cuda")
    with pytest.raises(ValueError, match="multiple of 8"):  # #8: the bf16 kernel's TMA boxes need it
        paged_attention_fused(
            torch.zeros((1, 8, 64), device="cuda"), pool12, pool12.clone(),
            torch.zeros((1, 1), dtype=torch.int32, device="cuda"), torch.ones(1, dtype=torch.int32, device="cuda"),
            k_new=torch.zeros((1, 2, 64), device="cuda"), v_new=torch.zeros((1, 2, 64), device="cuda"),
            write_rows=torch.zeros(1, dtype=torch.int32, device="cuda"),
        )
    with pytest.raises(ValueError, match="multiple of 8"):
        paged_attention_multi_fused(z[:, :4], pool12, pool12.clone(), *args, k_new=kv9[:, :4], v_new=kv9[:, :4],
                                    write_rows=torch.zeros((1, 4), dtype=torch.int32, device="cuda"))


REL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}  # ||kernel - plain|| / ||plain||, as chip_smoke.py holds them


def rel_err(a, w) -> float:
    a, w = a.double(), w.double()
    return ((a - w).norm() / w.norm().clamp_min(1e-300)).item()


def qkv_segs(gen, dtype, b, s, hq, hkv, segs, d=64):
    q = torch.randn((b, s, hq, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(dtype)
    seg = None
    if segs:
        seg = torch.zeros((b, s), dtype=torch.int32, device="cuda")
        seg[:, s // 3:] = 1
        seg[-1, 2 * s // 3:] = 2
    return q, k, v, seg


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hq,hkv", HEADS)
@pytest.mark.parametrize("s,causal,segs", [(77, True, False), (200, False, False), (130, True, True), (64, False, True),
                                           (1, True, False), (65, True, False), (65, False, True)])
def test_flash_backward_kernel_matches_plain(gen, dtype, d, hq, hkv, s, causal, segs):
    """dq, dk, dv against the plain backward: one row, a row past a tile (65;
    at head_dim 128 the f32 kernels' 32-row tiles also meet 33 and 97),
    ragged tiles, every GQA ratio. No atomics: a second launch gives the
    same bits."""
    q, k, v, seg = qkv_segs(gen, dtype, 2, s, hq, hkv, segs, d)
    o, lse = flash_attention_fwd(q, k, v, causal=causal, segment_ids=seg)
    do = torch.randn(o.shape, generator=gen, device="cuda").to(dtype)
    before = _build.launch_counts["flash_attention_bwd"]
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal, segment_ids=seg)
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_attention_bwd"] == before + 1
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, causal=causal, segment_ids=seg)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == b.dtype == dtype, name
        torch.testing.assert_close(a.float(), b.float(), atol=TOL[dtype], rtol=TOL[dtype], msg=name)
    again = flash_attention_bwd(q, k, v, o, lse, do, causal=causal, segment_ids=seg)
    for name, a, b in zip(("dq", "dk", "dv"), again, got):
        assert torch.equal(a, b), name


def hd128_segments(b, s, kind):
    """Segment ids [B, S]: thirds (the last row cut once more), or a segment of
    one token in the middle (a query that sees only itself)."""
    seg = torch.zeros((b, s), dtype=torch.int32, device="cuda")
    if kind == "segments":
        seg[:, s // 3:] = 1
        seg[-1, 2 * s // 3:] = 2
    else:
        j = s // 2
        seg[:, j] = 1
        seg[:, j + 1:] = 2
    return seg


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hq,hkv", HEADS)
@pytest.mark.parametrize("s", [1, 77, 130, 200, 769])
@pytest.mark.parametrize("mode", ["causal", "full", "segments", "one_token"])
def test_flash_hopper_bf16_kernels_match_plain(gen, d, hq, hkv, s, mode):
    """The Hopper bf16 forward (wgmma fed by TMA; head_dim 64 and 128) and the
    bf16 backward of each head_dim at ragged S (1, a part tile, whole key
    tiles plus a few rows, 769 = 6 128-key tiles + 1), every GQA ratio,
    causal, full and segment masks with a one-token segment; the backward
    from the plain forward's o and lse, so each kernel is held alone."""
    q, k, v, _ = qkv_segs(gen, torch.bfloat16, 2, s, hq, hkv, False, d)
    causal = mode != "full"
    seg = hd128_segments(2, s, mode) if mode in ("segments", "one_token") else None
    o, lse = flash_attention_fwd(q, k, v, causal=causal, segment_ids=seg)
    o_ref, lse_ref = flash_attention_reference(q, k, v, causal=causal, segment_ids=seg)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=TOL[torch.bfloat16], rtol=TOL[torch.bfloat16])
    torch.testing.assert_close(lse, lse_ref, atol=TOL[torch.bfloat16], rtol=TOL[torch.bfloat16])
    do = torch.randn(o.shape, generator=gen, device="cuda").to(torch.bfloat16)
    got = flash_attention_bwd(q, k, v, o_ref, lse_ref, do, causal=causal, segment_ids=seg)
    want = flash_attention_bwd_reference(q, k, v, o_ref, lse_ref, do, causal=causal, segment_ids=seg)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a.float(), b.float(), atol=TOL[torch.bfloat16], rtol=TOL[torch.bfloat16], msg=name)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("layout", ["fused_qkv", "heads_major"])
@pytest.mark.parametrize("hq,hkv", [(24, 8), (32, 8)])
def test_flash_hopper_bf16_kernels_take_strided_views(gen, d, layout, hq, hkv):
    """q, k and v as non-contiguous [B, S, H, d] views, the strides the
    forward's tensor maps read: slices of one fused [B, S, Hq + 2 Hkv, d]
    projection, or [B, H, S, d] tensors transposed (S stride below H's)."""
    b, s = 2, 200
    if layout == "fused_qkv":
        qkv = torch.randn((b, s, hq + 2 * hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
        q, k, v = qkv[:, :, :hq], qkv[:, :, hq:hq + hkv], qkv[:, :, hq + hkv:]
    else:
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda").to(torch.bfloat16).transpose(1, 2)
                   for h in (hq, hkv, hkv))
    assert not any(x.is_contiguous() for x in (q, k, v))
    for causal in (True, False):
        o, lse = flash_attention_fwd(q, k, v, causal=causal)
        o_ref, lse_ref = flash_attention_reference(q, k, v, causal=causal)
        torch.testing.assert_close(o.float(), o_ref.float(), atol=TOL[torch.bfloat16], rtol=TOL[torch.bfloat16])
        torch.testing.assert_close(lse, lse_ref, atol=TOL[torch.bfloat16], rtol=TOL[torch.bfloat16])
        do = torch.randn(o.shape, generator=gen, device="cuda").to(torch.bfloat16)
        got = flash_attention_bwd(q, k, v, o_ref, lse_ref, do, causal=causal)
        want = flash_attention_bwd_reference(q, k, v, o_ref, lse_ref, do, causal=causal)
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            torch.testing.assert_close(a.float(), w.float(), atol=TOL[torch.bfloat16], rtol=TOL[torch.bfloat16],
                                       msg=name)


@pytest.mark.parametrize("d,hq,hkv", [(64, 32, 8), (128, 24, 8)])  # 1B's heads; 3B's
@pytest.mark.parametrize("mode", ["causal", "full", "segments"])
def test_flash_hopper_bf16_backward_is_bitwise_reproducible(gen, d, hq, hkv, mode):
    """No atomics: the bf16 Hopper backward run twice on the same inputs (S
    769) gives bitwise equal dq, dk and dv at both head dims, each within
    ``REL`` of the plain gradients."""
    q, k, v, _ = qkv_segs(gen, torch.bfloat16, 2, 769, hq, hkv, False, d)
    causal = mode != "full"
    seg = hd128_segments(2, 769, mode) if mode == "segments" else None
    o, lse = flash_attention_fwd(q, k, v, causal=causal, segment_ids=seg)
    do = torch.randn(o.shape, generator=gen, device="cuda").to(torch.bfloat16)
    first = flash_attention_bwd(q, k, v, o, lse, do, causal=causal, segment_ids=seg)
    second = flash_attention_bwd(q, k, v, o, lse, do, causal=causal, segment_ids=seg)
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, causal=causal, segment_ids=seg)
    for name, a, b, w in zip(("dq", "dk", "dv"), first, second, want):
        assert torch.equal(a, b), name
        assert rel_err(a, w) <= REL[torch.bfloat16], name


def test_flash_autograd_on_cuda_runs_both_kernels(gen):
    q, k, v, _ = qkv_segs(gen, torch.float32, 1, 96, 8, 2, False)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    _build.launch_counts.clear()
    flash_attention(q, k, v).square().sum().backward()
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_attention_fwd"] == 1 and _build.launch_counts["flash_attention_bwd"] == 1
    q2, k2, v2 = (x.detach().clone().requires_grad_() for x in (q, k, v))
    o_ref, _ = flash_attention_reference(q2, k2, v2)
    o_ref.square().sum().backward()
    for a, b in ((q, q2), (k, k2), (v, v2)):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-4, rtol=1e-4)


def ce_inputs(gen, dtype, n, v, d, every=7):
    """h, E and labels with every ``every``-th label ignored (1: all of them)."""
    h = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
    e = (torch.randn((v, d), generator=gen, device="cuda") * 0.5).to(dtype)
    y = torch.randint(0, v, (n,), generator=gen, device="cuda", dtype=torch.int32)
    if every:
        y[::every] = -100
    return h, e, y


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("spread", [1.0, 4.0])
@pytest.mark.parametrize("n,v,d,every", [(100, 257, 128, 7), (64, 1000, 256, 7), (130, 4099, 128, 7),
                                         (16, 63, 128, 7), (200, 1001, 256, 7), (100, 1001, 128, 1),
                                         (100, 1001, 384, 7), (64, 129, 256, 7), (100, 256, 128, 7),
                                         (100, 511, 256, 7)])
def test_cross_entropy_kernels_match_plain(gen, dtype, spread, n, v, d, every):
    """lse, the dlogits pass and the dh / dE GEMMs against their plain
    versions: V not a multiple of 8 (the ldv pad) or of 128 (129: one row
    past a tile), V at, one past and short of a 256-column lse tile (256,
    257, 511), N not a multiple of 128, D a multiple of 128 but not of 256
    (384), every 7th label ignored or all of them (every=1), h scaled by
    ``spread`` (4: a peaked softmax). No atomics: a second launch of lse, dh
    and dE gives the same bits."""
    h, e, y = ce_inputs(gen, dtype, n, v, d, every)
    h = h * spread
    g = torch.tensor(0.37, device="cuda")
    lse = cross_entropy_lse_kernel(h, e)
    torch.testing.assert_close(lse, cross_entropy_lse(h, e), atol=TOL[dtype], rtol=TOL[dtype])
    assert torch.equal(cross_entropy_lse_kernel(h, e), lse)
    dl = cross_entropy_dlogits_kernel(h, e, y, lse, g)
    dh = cross_entropy_dh_kernel(h, e, y, lse, g)
    de = cross_entropy_de_kernel(h, e, y, lse, g)
    torch.cuda.synchronize()
    assert dh.dtype == de.dtype == dl.dtype == dtype and de.shape == e.shape and dl.shape == (n, v)
    torch.testing.assert_close(dl.float(), cross_entropy_dlogits(h, e, y, g).float(), atol=TOL[dtype], rtol=TOL[dtype])
    scratch = dl.as_strided((n, dl.stride(0)), (dl.stride(0), 1))
    assert not scratch[:, v:].any()  # the pad columns of the [N, ldv] scratch are 0
    torch.testing.assert_close(dh.float(), cross_entropy_dh(h, e, y, g).float(), atol=TOL[dtype], rtol=TOL[dtype])
    torch.testing.assert_close(de.float(), cross_entropy_de(h, e, y, g).float(), atol=TOL[dtype], rtol=TOL[dtype])
    assert torch.equal(cross_entropy_dh_kernel(h, e, y, lse, g), dh)
    assert torch.equal(cross_entropy_de_kernel(h, e, y, lse, g), de)
    if every == 1:
        assert not dl.any() and not dh.any() and not de.any()


LSE_ATOL = 1e-3  # the lse, absolute (chip_smoke.py's LSE_ATOL): far below a row's logit spread


def lse_once(h, e):
    """The kernel's lse, checked to count one ``cross_entropy_lse`` launch."""
    _build.launch_counts.clear()
    lse = cross_entropy_lse_kernel(h, e)
    assert dict(_build.launch_counts) == {"cross_entropy_lse": 1}
    return lse


def ce_inputs_tail_max(gen, n, v, d, spread):
    """bf16 h (scaled by ``spread``) and E, with row 1's largest logit in
    the last vocab column: E[V - 1] = h[1] / 2, a logit of |h_1|^2 / 2
    against the others' spread of sqrt(d) / 2 x ``spread``."""
    h, e, _ = ce_inputs(gen, torch.bfloat16, n, v, d)
    h = h * spread
    e[v - 1] = h[1] * 0.5
    assert int((h[1:2].float() @ e.float().T).argmax()) == v - 1
    return h, e


@pytest.mark.parametrize("n,v,d,spread", [
    (100, 256, 128, 1.0),     # the last 256-column tile full
    (100, 257, 128, 1.0),     # one column in the last tile
    (100, 511, 128, 1.0),     # a ragged last tile
    (300, 40_001, 256, 1.0),  # 157 tiles x 3 token tiles, more than the SMs: a block walks several, its ring crosses them
    (16, 1000, 128, 1.0),     # D 128: 2 K slabs, fewer than the 4 ring stages
    (130, 4099, 384, 1.0),    # D 384: 6 K slabs
    (130, 4099, 384, 4.0),    # spread 4: a peaked softmax
    (100, 511, 256, 4.0),
])
def test_cross_entropy_lse_bf16_hopper_matches_plain(gen, n, v, d, spread):
    """The bf16 lse (the Hopper GEMM's partial pass, then the merge) against
    the plain lse within ``LSE_ATOL``, one launch a call, bitwise equal over
    two launches. Row 1's max lies in the last (ragged) vocab tile; the
    control, the kernel's lse with that last column dropped, must miss."""
    h, e = ce_inputs_tail_max(gen, n, v, d, spread)
    lse = lse_once(h, e)
    want = cross_entropy_lse(h, e)
    assert lse.shape == (n,) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, want, atol=LSE_ATOL, rtol=0)
    assert torch.equal(lse_once(h, e), lse)
    dropped = lse_once(h, e[:-1])
    assert (dropped - want).abs().max().item() > LSE_ATOL


@pytest.mark.parametrize("bounds", [(0, 700, 1601, 3001), (0, 1, 257, 3001), (300, 2000)])
def test_cross_entropy_lse_bf16_hopper_on_vocab_slices(gen, bounds):
    """The bf16 lse over the views E[v0:v1] (v0 not a multiple of 256, as a
    tensor-parallel rank's slice: the TMA map starts mid-vocabulary), merged
    in order by :func:`cross_entropy_lse_merge_kernel`, against the plain
    lse over the same rows and the kernel's lse over them at once, within
    ``LSE_ATOL``; row 1's max lies in the last column. (300, 2000): one
    slice that starts at row 300."""
    n, d = 200, 256
    h, e = ce_inputs_tail_max(gen, n, bounds[-1], d, 1.0)
    e = e[bounds[0]:]
    v0s = [b - bounds[0] for b in bounds]
    parts = torch.stack([lse_once(h, e[a:b]) for a, b in zip(v0s, v0s[1:])])
    merged = cross_entropy_lse_merge_kernel(parts)
    want = cross_entropy_lse(h, e)
    torch.testing.assert_close(merged, want, atol=LSE_ATOL, rtol=0)
    torch.testing.assert_close(merged, lse_once(h, e), atol=LSE_ATOL, rtol=0)
    assert torch.equal(cross_entropy_lse_merge_kernel(parts), merged)


@pytest.mark.parametrize("n,v,d", [(100, 4099, 256), (300, 40_001, 512), (16, 129, 384)])
def test_cross_entropy_de_bf16_is_bitwise_reproducible(gen, n, v, d):
    """No split-K and no atomics: the bf16 dE product (the Hopper GEMM) run
    twice on the same dlogits gives bitwise equal outputs, at ragged V and N:
    fewer K slabs than ring stages (N 16, 100), and more output tiles than
    SMs with more slabs than stages (N 300, V 40,001), so a block's ring runs
    on across its tiles; both within ``REL`` of the plain product."""
    h, e, y = ce_inputs(gen, torch.bfloat16, n, v, d)
    g = torch.tensor(0.37, device="cuda")
    dl = cross_entropy_dlogits_kernel(h, e, y, cross_entropy_lse_kernel(h, e), g)
    first = cross_entropy_de_gemm_kernel(dl, h)
    second = cross_entropy_de_gemm_kernel(dl, h)
    torch.cuda.synchronize()
    assert first.shape == (v, d) and torch.equal(first, second)
    assert rel_err(first, dl.float().T @ h.float()) <= REL[torch.bfloat16]


@pytest.mark.parametrize("n,v,d", [(100, 4099, 256), (300, 40_001, 512), (16, 129, 384), (300, 4099, 128)])
@pytest.mark.parametrize("product", ["dlogits", "dh"])
def test_cross_entropy_hopper_products_are_bitwise_reproducible(gen, product, n, v, d):
    """The bf16 dlogits pass (A = h and B = E, both K-major) and dh GEMM (A =
    dlogits K-major, B = E MN-major) on the Hopper GEMM that dE runs on: two
    launches give bitwise equal outputs, within ``REL`` of the plain product,
    at ragged N and V, D a multiple of 256 and not (384, 128: 128-wide dh
    tiles), fewer K slabs than ring stages (dh at V 129) and more output
    tiles than SMs (dlogits at N 300, V 40,001), so a block's ring runs on
    across its tiles."""
    h, e, y = ce_inputs(gen, torch.bfloat16, n, v, d)
    h = h * 4.0  # a peaked softmax: real mass on a few columns
    g = torch.tensor(0.37, device="cuda")
    lse = cross_entropy_lse_kernel(h, e)
    dl = cross_entropy_dlogits_kernel(h, e, y, lse, g)
    if product == "dlogits":
        first, second = dl, cross_entropy_dlogits_kernel(h, e, y, lse, g)
        logits = h.float() @ e.float().T
        valid = (y != -100)[:, None]
        onehot = torch.zeros_like(logits).scatter_(1, torch.where(valid[:, 0], y, 0).long()[:, None], 1.0)
        want = torch.where(valid, (logits - lse[:, None]).exp() - onehot, 0.0) * g
    else:
        first, second = cross_entropy_dh_gemm_kernel(dl, e), cross_entropy_dh_gemm_kernel(dl, e)
        want = dl.float() @ e.float()
    torch.cuda.synchronize()
    assert first.shape == want.shape and torch.equal(first, second)
    assert rel_err(first, want) <= REL[torch.bfloat16]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("spread", [1.0, 4.0])
def test_cross_entropy_kernels_at_the_drives_shape(gen, dtype, spread):
    """The CE kernels at the 100m WER drive's training shape: one micro-batch
    of 32 x 160 tokens (N 5,120), D 512, the extended vocabulary (V 133,258),
    every 7th label ignored, E at the init scale (logits of std ``spread``):
    lse within 1e-3, dlogits, dh and dE within ``REL`` in relative norm."""
    n, v, d = 5120, 133_258, 512
    h = (torch.randn((n, d), generator=gen, device="cuda") * spread).to(dtype)
    e = (torch.randn((v, d), generator=gen, device="cuda") * d**-0.5).to(dtype)
    y = torch.randint(0, v, (n,), generator=gen, device="cuda", dtype=torch.int32)
    y[::7] = -100
    g = torch.tensor(1.0, device="cuda")
    lse = cross_entropy_lse_kernel(h, e)
    assert (lse - cross_entropy_lse(h, e)).abs().max().item() <= 1e-3
    dl = cross_entropy_dlogits_kernel(h, e, y, lse, g)
    assert rel_err(dl, cross_entropy_dlogits(h, e, y, g)) <= REL[dtype]
    del dl
    assert rel_err(cross_entropy_dh_kernel(h, e, y, lse, g), cross_entropy_dh(h, e, y, g)) <= REL[dtype]
    assert rel_err(cross_entropy_de_kernel(h, e, y, lse, g), cross_entropy_de(h, e, y, g)) <= REL[dtype]
    loss, loss_p = fused_cross_entropy_kernel(h, e, y), fused_cross_entropy(h, e, y)
    assert abs(loss.item() - loss_p.item()) <= 1e-5 * abs(loss_p.item())


def test_cross_entropy_autograd_all_ignored_and_counts(gen):
    h, e, y = ce_inputs(gen, torch.float32, 48, 300, 128)
    for labels in (y, torch.full_like(y, -100)):
        h1, e1 = h.clone().requires_grad_(), e.clone().requires_grad_()
        h2, e2 = h.clone().requires_grad_(), e.clone().requires_grad_()
        _build.launch_counts.clear()
        loss = fused_cross_entropy_kernel(h1, e1, labels)
        loss.backward()
        torch.cuda.synchronize()
        assert all(_build.launch_counts[name] == 1 for name in ("cross_entropy_lse", "cross_entropy_dlogits",
                                                                 "cross_entropy_dh", "cross_entropy_de"))
        ref = fused_cross_entropy(h2, e2, labels)
        ref.backward()
        torch.testing.assert_close(loss, ref, atol=1e-4, rtol=1e-5)
        torch.testing.assert_close(h1.grad, h2.grad, atol=1e-5, rtol=1e-4)
        torch.testing.assert_close(e1.grad, e2.grad, atol=1e-5, rtol=1e-4)
        if (labels == -100).all():
            assert float(loss.detach()) == 0.0 and not h1.grad.any() and not e1.grad.any()


def test_cross_entropy_kernels_refuse_unsupported_shapes(gen):
    # the GEMMs take dlogits rows that are 16-byte aligned (the dlogits pass's scratch), not any view
    h, e, y = ce_inputs(gen, torch.float32, 8, 10, 128)
    dl = torch.zeros((8, 12), device="cuda")[:, :10]
    with pytest.raises(ValueError, match="16-byte aligned rows"):
        cross_entropy_dh_gemm_kernel(dl, e)
    with pytest.raises(ValueError, match="16-byte aligned rows"):
        cross_entropy_de_gemm_kernel(dl, h)


# (D, q heads, kv heads): head_dim 64 with D a multiple of 128; head_dim 128 with n_rep 3, as 3B;
# tiny_test's own D 64, 4 q / 2 kv heads (head_dim 16)
@pytest.mark.parametrize("d,hq,hkv", [(128, 2, 1), (384, 3, 1), (64, 4, 2)])
def test_small_model_loss_and_grads_kernels_match_plain(gen, d, hq, hkv):
    """One f32 micro-batch through make_loss_fn on the card (the kernels) and
    on the CPU (the plain versions, chosen by device): same loss, same
    gradients (1e-4 of each leaf's largest entry)."""
    from ssi_tpu_torch.models.configs import get_model_config
    from ssi_tpu_torch.models.llama3 import init_params
    from ssi_tpu_torch.train.optimizer import tree_leaves, tree_unflatten
    from ssi_tpu_torch.train.step import make_loss_fn

    cfg = get_model_config("tiny_test")
    cfg.embed_dim, cfg.num_heads, cfg.num_kv_heads = d, hq, hkv
    params = init_params(cfg, seed=0, dtype=torch.float32, device="cuda")
    tokens = torch.randint(1, cfg.vocab_size, (2, 80), generator=gen, device="cuda", dtype=torch.int32)
    labels = tokens.clone()
    labels[:, :20] = -100
    out = []
    for device in ("cuda", "cpu"):
        leaves = [p.detach().to(device).requires_grad_() for p in tree_leaves(params)]
        loss, n = make_loss_fn(cfg)(tree_unflatten(params, leaves), tokens.to(device), labels.to(device))
        out.append((loss.detach().cpu(), int(n), [g.cpu() for g in torch.autograd.grad(loss, leaves)]))
    (l_k, n_k, g_k), (l_p, n_p, g_p) = out
    assert n_k == n_p
    torch.testing.assert_close(l_k, l_p, rtol=1e-5, atol=1e-4)
    for a, b in zip(g_k, g_p):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * b.abs().max().item())


# --- the shapes past the registry's head_dims and D (ROADMAP B1-B3): head_dim up to 128 in #1-#4 and
# #8/#9, any D in #5-#7, more than 64 query rows of a kv head in #8/#9 ---------------------------------

# 20, 100 and 131: not multiples of 8, run on padded copies; 136-256 on the hd-256 instance (256: Gemma's)
OTHER_HD = [16, 40, 72, 80, 96, 120, 20, 100, 136, 200, 256, 131]


def instance_width(d: int) -> int:
    """The head_dim of the kernel instance that runs head_dim ``d``."""
    return 64 if d <= 64 else 128 if d <= 128 else 256


def nan_view(x: torch.Tensor, width: int = 128) -> torch.Tensor:
    """``x [..., d]`` as the first d columns of a ``[..., width]`` buffer
    whose other columns hold NaN: a kernel that reads past d reads NaN."""
    buf = torch.full((*x.shape[:-1], width), float("nan"), dtype=x.dtype, device=x.device)
    buf[..., :x.shape[-1]] = x
    return buf[..., :x.shape[-1]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", OTHER_HD)
@pytest.mark.parametrize("hq,hkv", [(8, 2), (6, 2), (32, 8)])
@pytest.mark.parametrize("s,mode", [(77, "causal"), (200, "full"), (130, "segments")])
def test_flash_kernels_at_other_head_dims(gen, dtype, d, hq, hkv, s, mode):
    """#1-#4 at head_dims other than 64 and 128 (the hd-64 instance up to 64,
    the hd-128 one up to 128, the hd-256 one above, on tensor maps bounded at
    d; 20, 100 and 131 on copies padded to a multiple of 8): q, k and v column
    slices of 128- or 256-wide buffers whose other columns hold NaN; o, lse,
    dq, dk and dv against the plain versions, beside a control that must miss
    (the plain forward with the scale of the instance's width, 1/sqrt(64,
    128 or 256), or at 256 itself the keys of the next kv head); the backward
    bitwise equal over two launches."""
    q, k, v, _ = qkv_segs(gen, dtype, 2, s, hq, hkv, False, d)
    width = instance_width(d)
    q, k, v = (nan_view(x, max(width, 128)) for x in (q, k, v))
    causal = mode != "full"
    seg = hd128_segments(2, s, mode) if mode == "segments" else None
    o, lse = flash_attention_fwd(q, k, v, causal=causal, segment_ids=seg)
    o_ref, lse_ref = flash_attention_reference(q, k, v, causal=causal, segment_ids=seg)
    assert o.shape == q.shape and o.is_contiguous()
    torch.testing.assert_close(o.float(), o_ref.float(), atol=TOL[dtype], rtol=TOL[dtype])
    torch.testing.assert_close(lse, lse_ref, atol=TOL[dtype], rtol=TOL[dtype])
    if d == width:  # no other scale to tell apart: each q head routed to the next kv head
        o_ctl, _ = flash_attention_reference(q, k.roll(1, 2), v.roll(1, 2), causal=causal, segment_ids=seg)
    else:
        o_ctl, _ = flash_attention_reference(q * (d / width) ** 0.5, k, v, causal=causal, segment_ids=seg)
    assert not torch.allclose(o.float(), o_ctl.float(), atol=TOL[dtype], rtol=TOL[dtype])
    do = nan_view(torch.randn(o.shape, generator=gen, device="cuda").to(dtype), max(width, 128))
    got = flash_attention_bwd(q, k, v, o_ref, lse_ref, do, causal=causal, segment_ids=seg)
    want = flash_attention_bwd_reference(q, k, v, o_ref, lse_ref, do, causal=causal, segment_ids=seg)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == w.shape and a.dtype == w.dtype, name
        torch.testing.assert_close(a.float(), w.float(), atol=TOL[dtype], rtol=TOL[dtype],
                                   msg=lambda m, name=name: f"{name}: {m}")
    again = flash_attention_bwd(q, k, v, o_ref, lse_ref, do, causal=causal, segment_ids=seg)
    for name, a, b in zip(("dq", "dk", "dv"), again, got):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("d", [16, 80, 96, 256])
def test_flash_autograd_at_other_head_dims(gen, d):
    """:func:`flash_attention` differentiated at tiny_test's head_dim (16),
    phi-2's (80), Phi-3-mini's (96) and Gemma's (256) in f32: one launch of
    each kernel, gradients equal to the plain forward's autograd."""
    q, k, v, _ = qkv_segs(gen, torch.float32, 1, 96, 8, 2, False, d)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    _build.launch_counts.clear()
    flash_attention(q, k, v).square().sum().backward()
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_attention_fwd"] == 1 and _build.launch_counts["flash_attention_bwd"] == 1
    q2, k2, v2 = (x.detach().clone().requires_grad_() for x in (q, k, v))
    o_ref, _ = flash_attention_reference(q2, k2, v2)
    o_ref.square().sum().backward()
    for a, b in ((q, q2), (k, k2), (v, v2)):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-4, rtol=1e-4)


OTHER_D = [64, 72, 100, 576, 960, 8, 200]  # 100: not a multiple of 8, run on padded copies


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", OTHER_D)
@pytest.mark.parametrize("n,v,spread", [(100, 1001, 1.0), (130, 4099, 4.0)])
def test_cross_entropy_kernels_at_any_d(gen, dtype, d, n, v, spread):
    """#5-#7 at D not a multiple of 128 (tiny_test's 64, SmolLM's 576 and
    960; 100 and 8 below a 64-column slab): h a column slice of a wider
    buffer whose other columns hold NaN; lse, dlogits, dh and dE against the
    plain versions (E at init_params' scale, so the logits' std is
    ``spread``; dh and dE from the kernel's lse), dh beside a control that must miss
    (dh without its softmax term) and dE's unlabelled rows beside one (the
    plain version at lse + 0.05), each bitwise equal over two launches; the
    loss and its gradients through the autograd wrapper."""
    h, _, y = ce_inputs(gen, dtype, n, v, d)
    h = nan_view(h * spread, 1024)
    e = (torch.randn((v, d), generator=gen, device="cuda") * d**-0.5).to(dtype)  # init_params' scale: logit std spread
    g = torch.tensor(0.37, device="cuda")
    lse = cross_entropy_lse_kernel(h, e)
    torch.testing.assert_close(lse, cross_entropy_lse(h, e), atol=TOL[dtype], rtol=TOL[dtype])
    assert torch.equal(cross_entropy_lse_kernel(h, e), lse)
    dl = cross_entropy_dlogits_kernel(h, e, y, lse, g)
    torch.testing.assert_close(dl.float(), cross_entropy_dlogits(h, e, y, g).float(), atol=TOL[dtype], rtol=TOL[dtype])
    valid = y != -100
    unl = torch.ones(v, dtype=torch.bool, device="cuda")
    unl[y[valid].long()] = False
    dh_ctl = torch.where(valid[:, None], -g * e.float()[y.clamp(min=0).long()], 0.0)
    for name, kernel, plain in (("dh", cross_entropy_dh_kernel, cross_entropy_dh),
                                ("dE", cross_entropy_de_kernel, cross_entropy_de)):
        got = kernel(h, e, y, lse, g)
        want = plain(h, e, y, g, lse=lse)
        assert got.shape == want.shape and got.dtype == dtype and got.is_contiguous(), name
        # atol a fraction TOL of the largest entry: f32 sums over K = V = 4,099 products reach |dh| ~ 10 here
        torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype] * max(1.0, want.abs().max().item()),
                                   rtol=TOL[dtype], msg=lambda m, name=name: f"{name}: {m}")
        assert rel_err(got, want) <= REL[dtype], name
        if name == "dh":
            assert rel_err(dh_ctl, want) > REL[dtype]
        else:
            ctl = plain(h, e, y, g, lse=lse + 0.05)
            assert rel_err(got[unl], want[unl]) <= REL[dtype] < rel_err(ctl[unl], want[unl])
        assert torch.equal(kernel(h, e, y, lse, g), got), name
    h1, e1 = h.detach().clone().requires_grad_(), e.clone().requires_grad_()
    h2, e2 = h.detach().clone().requires_grad_(), e.clone().requires_grad_()
    loss = fused_cross_entropy_kernel(h1, e1, y)
    loss.backward()
    ref = fused_cross_entropy(h2, e2, y)
    ref.backward()
    assert abs(loss.item() - ref.item()) <= 1e-5 * abs(ref.item())
    for a, b in ((h1.grad, h2.grad), (e1.grad, e2.grad)):
        assert a.shape == b.shape and rel_err(a, b) <= REL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("poison", [False, True])
@pytest.mark.parametrize("hd,t_q,n_rep", [(16, 1, 2), (16, 4, 2), (40, 1, 4), (72, 4, 4), (80, 1, 4), (80, 8, 4),
                                          (96, 1, 4), (96, 4, 3), (120, 8, 8)])
@pytest.mark.parametrize("ps", [16, 128])
def test_paged_kernels_at_other_head_dims(gen, dtype, poison, hd, t_q, n_rep, ps):
    """#8 and #9 at head_dims other than 64 and 128 (tiny_test's 16, phi-2's
    80, Phi-3-mini's 96; the pools mapped 3D, so a box's columns past hd are
    zeros and never the next kv head's), on a table of three splits:
    histories on and one key past split boundaries, 0, and the full context
    less T, with every unused pool cell NaN or +-Inf when poisoned; each
    beside the roll control, two launches bitwise equal, pools bitwise
    equal except the trash row."""
    max_pages = 3 * SPLIT_KEYS // ps
    per_split, n_splits = split_plan(max_pages, ps)
    sk, cap = per_split * ps, max_pages * ps
    hist = [0, 1, ps - 1, ps, sk - 1, sk, sk + 1, 2 * sk + 1, cap - t_q, 37]
    active = [True] * 8 + [False, True]
    check_paged_kernel(gen, dtype, t_q, n_rep, ps, max_pages, hist, active, hd=hd, poison=poison)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("poison", [False, True])
# T * n_rep query rows of a kv head past 64: 72 (two row groups, the second of 8 rows), 128 (Llama 3.1
# 405B's 128 q / 8 kv heads at T 8), 128 at T 1 and T 4, 192 at head_dim 80
@pytest.mark.parametrize("hd,t_q,n_rep", [(64, 8, 9), (128, 8, 16), (64, 1, 128), (128, 4, 32), (80, 8, 24),
                                          (16, 8, 16)])
@pytest.mark.parametrize("ps", [16, 128])
def test_paged_kernels_past_64_query_rows(gen, dtype, poison, hd, t_q, n_rep, ps):
    """#8 and #9 with more than 64 query rows of a kv head: a block a row
    group of 64 (each reading the pages), the split merge counted per
    (slot, kv head, row group); on a table of three splits, as
    :func:`test_paged_kernels_at_other_head_dims`."""
    max_pages = 3 * SPLIT_KEYS // ps
    per_split, n_splits = split_plan(max_pages, ps)
    sk, cap = per_split * ps, max_pages * ps
    hist = [0, 1, sk - 1, sk, sk + 1, 2 * sk + 1, cap - t_q, 37]
    active = [True] * 6 + [False, True]
    check_paged_kernel(gen, dtype, t_q, n_rep, ps, max_pages, hist, active, hd=hd, poison=poison)


# #8 and #9 at head_dim 256 (Gemma 2B's 8 q / 1 kv heads: 8, 32 and 64 query rows at T 1, 4 and 8; Gemma 7B's
# 16 / 16: n_rep 1), 136 and 200 on the hd-256 instance, and at head_dims that are not multiples of 8 (36, 20,
# 131: the plain-load kernels, in bf16 too)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("poison", [False, True])
@pytest.mark.parametrize("hd,t_q,n_rep,hkv", [(256, 1, 8, 1), (256, 4, 8, 1), (256, 8, 8, 1), (256, 1, 1, 2),
                                              (256, 8, 1, 2), (136, 4, 3, 2), (200, 1, 4, 2), (36, 1, 4, 2),
                                              (36, 4, 4, 2), (20, 8, 2, 2), (131, 4, 2, 1)])
@pytest.mark.parametrize("ps", [16, 128])
def test_paged_kernels_past_head_dim_128_and_unaligned(gen, dtype, poison, hd, t_q, n_rep, hkv, ps):
    """#8 and #9 at the hd-256 instance's head_dims and at head_dims that are
    not multiples of 8, on a table of three splits, as
    :func:`test_paged_kernels_at_other_head_dims`: histories on and one key
    past split boundaries, 0, and the full context less T, every unused cell
    NaN or +-Inf when poisoned, beside the roll control, two launches
    bitwise equal, pools bitwise equal except the trash row."""
    max_pages = 3 * SPLIT_KEYS // ps
    per_split, n_splits = split_plan(max_pages, ps)
    sk, cap = per_split * ps, max_pages * ps
    hist = [0, 1, ps - 1, ps, sk - 1, sk, sk + 1, 2 * sk + 1, cap - t_q, 37]
    active = [True] * 8 + [False, True]
    check_paged_kernel(gen, dtype, t_q, n_rep, ps, max_pages, hist, active, hkv=hkv, hd=hd, poison=poison)


@pytest.mark.parametrize("d,hq,hkv", [(512, 2, 1), (512, 4, 4)])  # heads of 256: Gemma 2B's ratio, and 7B's
def test_small_model_loss_and_grads_kernels_match_plain_at_head_dim_256(gen, d, hq, hkv):
    """:func:`test_small_model_loss_and_grads_kernels_match_plain` at heads of
    256 (#1 and #3 on their hd-256 instances)."""
    test_small_model_loss_and_grads_kernels_match_plain(gen, d, hq, hkv)
