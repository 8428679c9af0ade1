"""The port's CUDA kernels against their plain versions on a CUDA card, at
small and odd shapes the chip smoke does not cover (ragged last q tile, every
supported GQA ratio). These need the card: they skip on a CPU-only machine
and run on the GPU with ``python -m pytest -m cuda tests/test_torch_cuda_kernels.py``."""

import pytest
import torch

from ssi_tpu_torch import _build
from ssi_tpu_torch.generate.paged_cuda import paged_attention_fused, paged_attention_fused_reference
from ssi_tpu_torch.ops.flash_attention import flash_attention_fwd, flash_attention_reference

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
@pytest.mark.parametrize("hq,hkv", [(8, 8), (8, 4), (8, 2), (32, 8)])
@pytest.mark.parametrize("s,causal,segs", [(77, True, False), (200, False, False), (130, True, True)])
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
