"""The port's CUDA kernels against their plain versions on a CUDA card, at
small and odd shapes the chip smoke does not cover (ragged last q or key
tile, every GQA ratio, odd vocab, ignored rows, f32 and bf16), and a small
train step with the kernels against the same step with the plain versions.
These need the card: they skip on a CPU-only machine and run on the GPU with
``python -m pytest -m cuda tests/test_torch_cuda_kernels.py``."""

import pytest
import torch

from ssi_tpu_torch import _build
from ssi_tpu_torch.generate.paged import paged_attention
from ssi_tpu_torch.generate.paged_cuda import (
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv", [(8, 8), (8, 4), (8, 2), (8, 1), (32, 8)])  # n_rep 1, 2, 4, 8, 4
@pytest.mark.parametrize("s,causal,segs", [(77, True, False), (200, False, False), (130, True, True),
                                           (200, False, True), (77, True, True)])
def test_flash_kernel_matches_plain(gen, dtype, hq, hkv, s, causal, segs):
    q = torch.randn((2, s, hq, 64), generator=gen, device="cuda").to(dtype)
    k = torch.randn((2, s, hkv, 64), generator=gen, device="cuda").to(dtype)
    v = torch.randn((2, s, hkv, 64), generator=gen, device="cuda").to(dtype)
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
@pytest.mark.parametrize("n_rep", [1, 2, 4, 8])
def test_paged_kernel_matches_plain(gen, dtype, n_rep):
    slots, hkv, ps, max_pages, n_pages = 6, 2, 16, 5, 40
    rows = 2 * n_pages + 1
    kp = torch.randn((rows, ps, hkv * 64), generator=gen, device="cuda").to(dtype)
    vp = torch.randn((rows, ps, hkv * 64), generator=gen, device="cuda").to(dtype)
    q = torch.randn((slots, hkv * n_rep, 64), generator=gen, device="cuda").to(dtype)
    kn = torch.randn((slots, hkv, 64), generator=gen, device="cuda").to(dtype)
    vn = torch.randn((slots, hkv, 64), generator=gen, device="cuda").to(dtype)
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
@pytest.mark.parametrize("n_rep,t_q", [(1, 2), (2, 2), (4, 2), (4, 3), (2, 8), (4, 4), (8, 4), (8, 8)])
def test_paged_multi_kernel_matches_plain(gen, dtype, n_rep, t_q):
    """Kernel #9 against its plain version: ragged history (0, mid-page,
    page-crossing spans, more than one 64-key tile, full context less T), an
    inactive slot, and a slot whose write cap cuts the span. Attention is
    compared on tokens whose own and earlier writes land; pools bitwise
    except the trash row."""
    slots, hkv, ps, max_pages, n_pages = 7, 2, 16, 10, 80
    rows = 2 * n_pages + 1
    trash = rows - 1
    kp = torch.randn((rows, ps, hkv * 64), generator=gen, device="cuda").to(dtype)
    vp = torch.randn((rows, ps, hkv * 64), generator=gen, device="cuda").to(dtype)
    q = torch.randn((slots, t_q, hkv * n_rep, 64), generator=gen, device="cuda").to(dtype)
    kn = torch.randn((slots, t_q, hkv, 64), generator=gen, device="cuda").to(dtype)
    vn = torch.randn((slots, t_q, hkv, 64), generator=gen, device="cuda").to(dtype)
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


def check_paged_kernel(gen, dtype, t_q, n_rep, ps, max_pages, hist, active, hkv=2):
    """One of the paged kernels, #8 (``t_q`` 1: seq_lens = hist + 1, 0 when
    inactive) or #9, against its plain version on slots of history ``hist``
    (positions < hist_len; inactive slots write to the trash row): attention
    of active slots within tolerance, two launches bitwise equal (the second
    rewrites the same cells, which no launch reads), pools bitwise equal
    except the trash row."""
    slots = len(hist)
    n_pages = slots * max_pages
    rows = 2 * n_pages + 1  # layer 1's pages, the trash row last
    kp = torch.randn((rows, ps, hkv * 64), generator=gen, device="cuda").to(dtype)
    vp = torch.randn((rows, ps, hkv * 64), generator=gen, device="cuda").to(dtype)
    table = (n_pages + torch.randperm(n_pages, generator=gen, device="cuda")).view(slots, max_pages).to(torch.int32)
    hist = torch.tensor(hist, dtype=torch.int32, device="cuda")
    active = torch.tensor(active, device="cuda")
    shape = (slots,) if t_q == 1 else (slots, t_q)
    q = torch.randn((*shape, hkv * n_rep, 64), generator=gen, device="cuda").to(dtype)
    kn = torch.randn((*shape, hkv, 64), generator=gen, device="cuda").to(dtype)
    vn = torch.randn((*shape, hkv, 64), generator=gen, device="cuda").to(dtype)
    pos = hist[:, None] + torch.arange(t_q, device="cuda")[None, :]
    write_rows = torch.where(active[:, None], torch.gather(table, 1, (pos // ps).long()), rows - 1).to(torch.int32)
    kw = dict(k_new=kn, v_new=vn, write_rows=write_rows[:, 0] if t_q == 1 else write_rows)
    if t_q == 1:
        lens = torch.where(active, hist + 1, 0).to(torch.int32)
        kernel, plain = paged_attention_fused, paged_attention_fused_reference
    else:
        lens = hist
        kernel, plain = paged_attention_multi_fused, paged_attention_multi_fused_reference
    kp_ref, vp_ref = kp.clone(), vp.clone()
    got = kernel(q, kp, vp, table, lens, **kw)
    again = kernel(q, kp, vp, table, lens, **kw)
    ref = plain(q, kp_ref, vp_ref, table, lens, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got[active].float(), ref[active].float(), atol=TOL[dtype], rtol=TOL[dtype])
    assert torch.equal(kp[:-1], kp_ref[:-1]) and torch.equal(vp[:-1], vp_ref[:-1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t_q,n_rep", [(1, 4), (1, 8), (4, 4), (8, 4), (8, 8)])  # #8 and #9; 8 x 8 = two row groups
@pytest.mark.parametrize("ps,max_pages", [(16, 48), (128, 10)])  # 3 and 5 splits of 256 keys
def test_paged_kernels_split_boundaries(gen, dtype, t_q, n_rep, ps, max_pages):
    """The split-context kernels where splits start and end: histories that
    end exactly on a split boundary and one key past it, one that fits in one
    split (finished by that split alone), history 0 (the only live split
    holds no history key), an inactive slot, and the full context less T."""
    per_split, n_splits = split_plan(max_pages, ps)
    sk, cap = per_split * ps, max_pages * ps
    assert n_splits > 1
    hist = [0, 100, sk - 1, sk, sk + 1, 2 * sk, 2 * sk + 1, cap - t_q, 0, 37]
    active = [True] * 8 + [False, True]
    check_paged_kernel(gen, dtype, t_q, n_rep, ps, max_pages, hist, active)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t_q", [1, 4])
def test_paged_kernels_past_the_old_context_cap(gen, dtype, t_q):
    """32 slots at context 16,384, n_rep 4: the old #8 kept every score in
    shared memory and its wrapper refused this shape; the split plan caps
    the splits at 16 of 1,024 keys each."""
    ps, max_pages = 128, 128
    cap = ps * max_pages
    assert split_plan(max_pages, ps) == (8, 16)
    hist = [cap - t_q, 0, 1, 1024, 1025] + torch.randint(1, cap - t_q + 1, (27,), generator=gen, device="cuda").tolist()
    check_paged_kernel(gen, dtype, t_q, 4, ps, max_pages, hist, [True] * 32)


def test_kernel_wrappers_refuse_unsupported_shapes(gen):
    q = torch.randn((1, 16, 4, 32), generator=gen, device="cuda")
    with pytest.raises(ValueError, match="head_dim 64"):
        flash_attention_fwd(q, q, q)
    kp = torch.zeros((3, 8, 3 * 64), device="cuda")
    with pytest.raises(ValueError, match="n_rep"):
        paged_attention_fused(
            torch.zeros((1, 9, 64), device="cuda"), kp, kp.clone(),
            torch.zeros((1, 1), dtype=torch.int32, device="cuda"), torch.ones(1, dtype=torch.int32, device="cuda"),
            k_new=torch.zeros((1, 3, 64), device="cuda"), v_new=torch.zeros((1, 3, 64), device="cuda"),
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
    with pytest.raises(ValueError, match="multiple of 8"):
        paged_attention_multi_fused(z[:, :4], pool12, pool12.clone(), *args, k_new=kv9[:, :4], v_new=kv9[:, :4],
                                    write_rows=torch.zeros((1, 4), dtype=torch.int32, device="cuda"))


def qkv_segs(gen, dtype, b, s, hq, hkv, segs):
    q = torch.randn((b, s, hq, 64), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, s, hkv, 64), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, s, hkv, 64), generator=gen, device="cuda").to(dtype)
    seg = None
    if segs:
        seg = torch.zeros((b, s), dtype=torch.int32, device="cuda")
        seg[:, s // 3:] = 1
        seg[-1, 2 * s // 3:] = 2
    return q, k, v, seg


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv", [(8, 8), (8, 4), (8, 2), (8, 1), (32, 8)])
@pytest.mark.parametrize("s,causal,segs", [(77, True, False), (200, False, False), (130, True, True), (64, False, True),
                                           (1, True, False), (65, True, False), (65, False, True)])
def test_flash_backward_kernel_matches_plain(gen, dtype, hq, hkv, s, causal, segs):
    """dq, dk, dv against the plain backward: one row, a row past a tile (65),
    ragged tiles, every GQA ratio. No atomics: a second launch gives the same
    bits."""
    q, k, v, seg = qkv_segs(gen, dtype, 2, s, hq, hkv, segs)
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
                                         (16, 63, 128, 7), (200, 1001, 256, 7), (100, 1001, 128, 1)])
def test_cross_entropy_kernels_match_plain(gen, dtype, spread, n, v, d, every):
    """lse, the dlogits pass and the dh / dE GEMMs against their plain
    versions: V not a multiple of 8 (the ldv pad) or of 128, N not a multiple
    of 128, every 7th label ignored or all of them (every=1), h scaled by
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
    h, e, y = ce_inputs(gen, torch.float32, 8, 10, 64)
    with pytest.raises(ValueError, match="multiple of 128"):
        cross_entropy_lse_kernel(h, e)
    # the GEMMs take dlogits rows that are 16-byte aligned (the dlogits pass's scratch), not any view
    h, e, y = ce_inputs(gen, torch.float32, 8, 10, 128)
    dl = torch.zeros((8, 12), device="cuda")[:, :10]
    with pytest.raises(ValueError, match="16-byte aligned rows"):
        cross_entropy_dh_gemm_kernel(dl, e)
    with pytest.raises(ValueError, match="16-byte aligned rows"):
        cross_entropy_de_gemm_kernel(dl, h)


def test_small_model_loss_and_grads_kernels_match_plain(gen):
    """One f32 micro-batch through make_loss_fn on the card (the kernels) and
    on the CPU (the plain versions, chosen by device): same loss, same
    gradients (1e-4 of each leaf's largest entry)."""
    from ssi_tpu_torch.models.configs import get_model_config
    from ssi_tpu_torch.models.llama3 import init_params
    from ssi_tpu_torch.train.optimizer import tree_leaves, tree_unflatten
    from ssi_tpu_torch.train.step import make_loss_fn

    cfg = get_model_config("tiny_test")
    cfg.embed_dim, cfg.num_heads, cfg.num_kv_heads = 128, 2, 1  # head_dim 64, D a multiple of 128
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
