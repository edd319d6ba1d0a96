"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips where there is no CUDA device. This file
imports no JAX, so it runs where only PyTorch is installed:

  PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import adaln_rmsnorm as tar
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ssm_scan as tss

# bf16 outputs: the kernel and the plain version round at the same places,
# after f32 sums taken in another order -> one or two bf16 ulps
BF16_TOL = 2e-2


def _assert_attention_close(got, want):
    """Attention outputs of N(0, 1) inputs are small (rms ~ sqrt(e / L)), so
    the limits scale with their rms, as in chip_smoke.py: elementwise
    3e-2 * rms(query row) + 2**-6 * |want| (two bf16 ulps), and
    rms(err) <= 5e-3 * rms."""
    d = (got.float() - want.float()).abs()
    w = want.float()
    row = w.pow(2).mean(dim=(2, 3), keepdim=True).sqrt()
    assert (d <= 3e-2 * row + 2.0 ** -6 * w.abs()).all(), d.max().item()
    assert d.pow(2).mean().sqrt() <= 5e-3 * w.pow(2).mean().sqrt()


def _qkv(seed, b, lq, lkv, h, d):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, n, h, d)).astype(np.float32))
            for n in (lq, lkv, lkv)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; run on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("l,d,causal,window,softcap", [
    (1101, 64, False, 0, 0.0), (333, 128, False, 0, 0.0), (96, 64, True, 16, 30.0),
    (200, 64, True, 0, 0.0),
])
def test_flash_attention_kernel_matches_plain_on_card(cuda, l, d, causal, window, softcap):
    q, k, v = (t.to(cuda, torch.bfloat16) for t in _qkv(7, 1, l, l, 4, d))
    got = tfa.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)
    mask = ops.attention_mask(l, l, window, cuda) if causal else None
    want = ref.attention_ref(q, k, v, mask, softcap)
    _assert_attention_close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("l", [1, 127, 128, 129, 255, 257])
@pytest.mark.parametrize("d,causal", [(64, False), (128, True)])
def test_flash_attention_kernel_at_tile_edges_on_card(cuda, l, d, causal):
    """Lengths on and beside K1's 128-row query and 128-key tiles."""
    q, k, v = (t.to(cuda, torch.bfloat16) for t in _qkv(l, 2, l, l, 3, d))
    got = tfa.flash_attention(q, k, v, causal=causal)
    mask = ops.attention_mask(l, l, 0, cuda) if causal else None
    _assert_attention_close(got, ref.attention_ref(q, k, v, mask))


@pytest.mark.gpu
@pytest.mark.parametrize("l,h,d,causal", [
    (1101, 24, 128, False), (4173, 24, 128, False),     # flux's DiT at 512 and 1024 px
    (7277, 48, 64, False),                              # cogvideox's at 480 px x 2 s
    (4433, 24, 128, False),                             # hunyuanvideo's at 540 px x 1 s
    (77, 32, 128, True),                                # hunyuanvideo's causal encoder
])
def test_flash_attention_kernel_at_the_diffusion_serving_shapes_on_card(cuda, l, h, d, causal):
    """The shapes the flux, cogvideox and hunyuanvideo serve gives K1; the
    plain version goes eight heads at a time (48 heads of f32 scores at
    L=7277 would take 10 GB)."""
    q, k, v = (t.to(cuda, torch.bfloat16) for t in _qkv(l + h, 1, l, l, h, d))
    got = tfa.flash_attention(q, k, v, causal=causal)
    mask = ops.attention_mask(l, l, 0, cuda) if causal else None
    want = torch.cat([ref.attention_ref(q[:, :, i:i + 8], k[:, :, i:i + 8], v[:, :, i:i + 8],
                                        mask) for i in range(0, h, 8)], dim=2)
    _assert_attention_close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("l", [1, 63, 64, 65, 127, 129, 257])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_kernel_at_head_dim_256_tile_edges_on_card(cuda, l, causal):
    """gemma2's head dim: lengths on and beside its 64-key tiles and
    64-row query blocks."""
    q, k, v = (t.to(cuda, torch.bfloat16) for t in _qkv(l + 1, 2, l, l, 2, 256))
    got = tfa.flash_attention(q, k, v, causal=causal)
    mask = ops.attention_mask(l, l, 0, cuda) if causal else None
    _assert_attention_close(got, ref.attention_ref(q, k, v, mask))


@pytest.mark.gpu
@pytest.mark.parametrize("lq,lkv,h,window,softcap", [
    (300, 300, 2, 130, 0.0),                   # a window across tiles
    (300, 300, 2, 48, 50.0),                   # gemma2's local layers (window cut)
    (200, 200, 4, 0, 30.0), (333, 333, 2, 0, 50.0),   # a softcap alone
    (100, 300, 4, 0, 0.0), (100, 300, 2, 48, 50.0),   # q_offset > 0
    (1100, 1100, 4, 512, 50.0),               # phase 7's gemma2 cut
])
def test_flash_attention_kernel_at_head_dim_256_masks_on_card(cuda, lq, lkv, h, window, softcap):
    q, k, v = (t.to(cuda, torch.bfloat16) for t in _qkv(lq + 2 * lkv, 1, lq, lkv, h, 256))
    got = tfa.flash_attention(q, k, v, causal=True, window=window, softcap=softcap)
    want = ref.attention_ref(q, k, v, ops.attention_mask(lq, lkv, window, cuda), softcap)
    _assert_attention_close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("lq,lkv,h,d,window,softcap", [
    (100, 300, 4, 64, 0, 0.0), (1, 1810, 4, 128, 0, 0.0),     # q_offset > 0
    (300, 300, 2, 64, 130, 0.0),                               # a window across tiles
    (300, 300, 2, 128, 0, 50.0), (129, 400, 2, 128, 100, 30.0),  # softcap at D=128
])
def test_flash_attention_kernel_masks_on_card(cuda, lq, lkv, h, d, window, softcap):
    q, k, v = (t.to(cuda, torch.bfloat16) for t in _qkv(lq + lkv, 2, lq, lkv, h, d))
    got = tfa.flash_attention(q, k, v, causal=True, window=window, softcap=softcap)
    want = ref.attention_ref(q, k, v, ops.attention_mask(lq, lkv, window, cuda), softcap)
    _assert_attention_close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["fused", "head_major"])
@pytest.mark.parametrize("d,causal", [(64, False), (128, True)])
def test_flash_attention_kernel_reads_strided_views_of_a_fused_projection(cuda, d, causal,
                                                                          layout):
    """q, k and v as views of one (B, L, 3, H, D) projection, or of
    (B, H, L, D) tensors transposed: strides a multiple of 8, no tensor
    contiguous on its own, the head stride above the row stride in the
    second."""
    b, l, h = 2, 333, 3
    rng = np.random.default_rng(d)
    if layout == "fused":
        qkv = torch.from_numpy(rng.standard_normal((b, l, 3, h, d)).astype(np.float32))
        q, k, v = qkv.to(cuda, torch.bfloat16).unbind(2)
        assert q.stride() == (l * 3 * h * d, 3 * h * d, d, 1)
    else:
        q, k, v = (torch.from_numpy(rng.standard_normal((b, h, l, d)).astype(np.float32))
                   .to(cuda, torch.bfloat16).transpose(1, 2) for _ in range(3))
        assert q.stride() == (h * l * d, d, l * d, 1)
    assert not q.is_contiguous()
    got = tfa.flash_attention(q, k, v, causal=causal)
    mask = ops.attention_mask(l, l, 0, cuda) if causal else None
    _assert_attention_close(got, ref.attention_ref(q.contiguous(), k.contiguous(),
                                                   v.contiguous(), mask))


@pytest.mark.gpu
@pytest.mark.parametrize("l,chunk,d", [(333, 128, 128), (300, 100, 64), (129, 128, 128),
                                       (100, 128, 64)])
def test_chunked_attention_runs_k1_once_per_chunk_on_views_on_card(cuda, l, chunk, d):
    """llama4's chunked prefill: one causal K1 call per chunk, each on views
    of q, k and v along L (no copies), equals the plain attention under the
    chunked mask."""
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.models import transformer
    cfg = dataclasses.replace(get_smoke("llama4-maverick-400b-a17b"), chunk_size=chunk,
                              dtype=torch.bfloat16)
    layer = transformer.AttentionLayer(cfg, "attn_chunked", cuda)
    q, k, v = (t.to(cuda, torch.bfloat16) for t in _qkv(l, 2, l, l, 4, d))
    pos = torch.arange(l, device=cuda)
    ops.reset_launches()
    got = layer._attention(q, k, v, pos)
    assert ops.LAUNCHES["flash_attention"] == -(-l // chunk)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] // chunk == pos[:, None] // chunk)
    _assert_attention_close(got, ref.attention_ref(q, k, v, mask))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1536, 3072])         # sd3's DiT width; the other three's
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("b,l", [(2, 333), (3, 1101), (4, 77), (5, 9)])
def test_adaln_rmsnorm_kernel_matches_plain_on_card(cuda, dtype, tol, d, b, l):
    """Each batch row has its own modulation row (rows of the DiT's (B, 6, D)
    modulation) and ends in a ragged block where L is no multiple of the
    plan's rows per block; a second call of the same signature takes the
    remembered launch and gives the same bits."""
    g = torch.Generator(device=cuda).manual_seed(b * l + d)
    x = torch.randn((b, l, d), generator=g, device=cuda).to(dtype)
    mod = (torch.randn((b, 6, d), generator=g, device=cuda) * 0.5).to(dtype)
    got = tar.adaln_rmsnorm(x, mod[:, 0], mod[:, 1])
    want = ref.adaln_rmsnorm_ref(x, mod[:, 0], mod[:, 1])
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert torch.equal(tar.adaln_rmsnorm(x, mod[:, 0], mod[:, 1]), got)


@pytest.mark.gpu
def test_adaln_rmsnorm_remembered_signature_still_checks_alignment(cuda):
    buf = torch.randn(2 * 77 * 128 + 4, device=cuda)
    mod = torch.randn((2, 6, 128), device=cuda)
    x = buf[:2 * 77 * 128].view(2, 77, 128)
    tar.adaln_rmsnorm(x, mod[:, 0], mod[:, 1])
    shifted = buf[1:1 + 2 * 77 * 128].view(2, 77, 128)      # same signature, 4 bytes off
    with pytest.raises(ValueError, match="aligned"):
        tar.adaln_rmsnorm(shifted, mod[:, 0], mod[:, 1])
    with pytest.raises(ValueError, match="aligned"):
        tar.adaln_rmsnorm(x, buf[1:257].view(2, 128), mod[:, 1])


@pytest.mark.gpu
def test_ops_count_kernel_launches_on_card(cuda):
    ops.reset_launches()
    q, k, v = (t.to(cuda, torch.bfloat16) for t in _qkv(8, 1, 77, 77, 2, 64))
    ops.flash_attention(q, k, v, causal=False)
    x = q.reshape(1, 77, 128)
    ops.adaln_rmsnorm(x, x[:, 0], x[:, 1])
    q4 = q.permute(0, 2, 1, 3)
    ops.linear_scan(q4, q4, q4, torch.rand(q4.shape, device=cuda))
    assert ops.LAUNCHES == {"flash_attention": 1, "adaln_rmsnorm": 1, "ssm_scan": 1}


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take(cuda):
    q, k, v = (t.to(cuda) for t in _qkv(9, 1, 8, 8, 2, 64))
    with pytest.raises(ValueError, match="bfloat16"):
        tfa.flash_attention(q, k, v)                     # float32
    q, k, v = (t.to(cuda, torch.bfloat16) for t in _qkv(9, 1, 8, 8, 2, 32))
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention(q, k, v)
    q, k, v = (t.to(cuda).permute(0, 2, 1, 3) for t in _qkv(9, 1, 8, 8, 2, 64))
    with pytest.raises(ValueError, match="float32 decay"):
        tss.ssm_scan(q, k, v, q.to(torch.bfloat16).float().half())
    with pytest.raises(ValueError, match="K and V"):
        tss.ssm_scan(*(torch.cat([t, t], -1) for t in (q, k, v, q)))


def _assert_scan_close(got, want):
    """K3 against its plain version: both keep the state and every sum in
    f32 and differ only in the order of the sums over K, so the state and
    f32 outputs agree to 1e-5 of their rms; bf16 outputs are the same f32
    values rounded, hence one bf16 ulp (2**-7 relative) apart at most."""
    for g, w in zip(got, want):
        w = w.float()
        d = (g.float() - w).abs()
        rms = w.pow(2).mean().sqrt()
        rel = 2.0 ** -7 if g.dtype == torch.bfloat16 else 1e-5
        assert (d <= 1e-5 * rms + rel * w.abs()).all(), d.max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,l,dk,dv,bonus,dtype,layout", [
    (2, 40, 300, 64, 64, True, torch.bfloat16, "per-head"),   # rwkv6's heads
    (2, 64, 300, 64, 64, False, torch.bfloat16, "zamba2"),    # B/C shared, decay per head
    (2, 64, 300, 64, 64, False, torch.bfloat16, "shared"),    # B/C and decay shared
    (2, 2, 100, 16, 32, False, torch.float32, "per-head"),
    (1, 1, 7, 4, 4, True, torch.float32, "per-head"),
    (8, 64, 70, 64, 40, True, torch.float32, "per-head"),     # narrower slices, V ragged
])
def test_ssm_scan_kernel_matches_plain_on_card(cuda, b, h, l, dk, dv, bonus, dtype, layout):
    """Layouts as chip_smoke.scan_inputs names them: "zamba2" is what Mamba2
    passes (models/ssm.py), q and k stride-0 across heads and the decay one
    value per (token, head), stride 0 over K."""
    g = torch.Generator(device=cuda).manual_seed(b * h + l)
    rn = lambda *s: torch.randn(s, generator=g, device=cuda)
    hq = h if layout == "per-head" else 1
    q, k = (rn(b, hq, l, dk).to(dtype).expand(b, h, l, dk) for _ in range(2))
    decay = torch.exp(-torch.exp(rn(b, 1 if layout == "shared" else h, l,
                                    dk if layout == "per-head" else 1))).expand(b, h, l, dk)
    v = rn(b, h, l, dv).to(dtype)
    u = rn(h, dk) if bonus else None
    s0 = rn(b, h, dk, dv)
    got = tss.ssm_scan(q, k, v, decay, bonus=u, initial_state=s0)
    _assert_scan_close(got, ref.ssm_scan_ref(q, k, v, decay, u, s0))


@pytest.mark.gpu
@pytest.mark.parametrize("bonus", [False, True])
def test_ssm_scan_kernel_at_the_decay_floor_does_not_depend_on_chunks(cuda, bonus):
    """Every decay at exp(-5.4): finite, on the plain version, and the same
    when the sequence is cut at a point that is not a chunk boundary and the
    state carried over."""
    g = torch.Generator(device=cuda).manual_seed(3)
    b, h, l, d = 2, 3, 5 * tss.CHUNK + 7, 64
    q, k, v = (torch.randn((b, h, l, d), generator=g, device=cuda) for _ in range(3))
    decay = torch.full((b, h, l, d), float(np.exp(-tss.MAX_NEG_LOGW)), device=cuda)
    u = torch.randn((h, d), generator=g, device=cuda) if bonus else None
    o, s = tss.ssm_scan(q, k, v, decay, bonus=u)
    assert torch.isfinite(o).all() and torch.isfinite(s).all()
    _assert_scan_close((o, s), ref.ssm_scan_ref(q, k, v, decay, u))
    cut = tss.CHUNK + 5
    o1, s1 = tss.ssm_scan(q[:, :, :cut], k[:, :, :cut], v[:, :, :cut], decay[:, :, :cut],
                          bonus=u)
    o2, s2 = tss.ssm_scan(q[:, :, cut:], k[:, :, cut:], v[:, :, cut:], decay[:, :, cut:],
                          bonus=u, initial_state=s1)
    _assert_scan_close((torch.cat([o1, o2], 2), s2), (o, s))


@pytest.mark.gpu
def test_ssm_scan_kernel_staging_paths_on_card(cuda):
    """The served layouts take the TMA staging (rwkv6's head views of (B, L,
    H*64) rows; zamba2's B/C slices of its conv rows, shared across heads,
    and its per-head decay on the per-token path); a last stride other than
    1 takes the element-wise copy into the same ring and agrees with the
    plain version all the same."""
    g = torch.Generator(device=cuda).manual_seed(11)
    rn = lambda *s: torch.randn(s, generator=g, device=cuda)
    b, l, h = 2, 70, 4
    heads = lambda t: t.reshape(b, l, h, 64).transpose(1, 2)
    q, k, v = (heads(rn(b, l, h * 64).to(torch.bfloat16)) for _ in range(3))
    w = heads(torch.exp(-torch.exp(rn(b, l, h * 64))))
    assert tss.plan(q, k, v, w)["staging"] == "tma"
    xbc = rn(b, l, h * 64 + 2 * 64).to(torch.bfloat16)
    bs, cs = xbc[..., h * 64:h * 64 + 64], xbc[..., h * 64 + 64:]
    qz, kz = (t[:, None].expand(b, h, l, 64) for t in (cs, bs))
    wz = torch.exp(-torch.exp(rn(b, l, h))).transpose(1, 2)[..., None].expand(b, h, l, 64)
    p = tss.plan(qz, kz, v, wz)
    assert p["staging"] == "tma" and p["decay"] == "per-token"
    _assert_scan_close(tss.ssm_scan(qz, kz, v, wz), ref.ssm_scan_ref(qz, kz, v, wz))
    qt, kt, vt = (rn(b, h, 64, l).to(torch.bfloat16).transpose(2, 3) for _ in range(3))
    assert tss.plan(qt, kt, vt, w)["staging"] == "element-wise q,k,v"
    u = rn(h, 64)
    _assert_scan_close(tss.ssm_scan(qt, kt, vt, w, bonus=u), ref.ssm_scan_ref(qt, kt, vt, w, u))


TRAIN_ARCHS = ("yi-9b", "gemma2-9b", "deepseek-moe-16b", "rwkv6-3b", "zamba2-1.2b",
               "llama4-maverick-400b-a17b", "internvl2-2b", "musicgen-medium")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_on_card_matches_cpu(cuda, arch):
    """One train step of a smoke config (float32) on the card against the
    same weights and batch on the CPU: the loss terms, each gradient (rms
    of the difference against rms) and the updated parameters. The training
    pass runs no kernel on the card."""
    import repro_torch.configs as TC
    from repro_torch.data import pipeline
    from repro_torch.models import transformer
    from repro_torch.training import loop, optimizer

    cfg = TC.get_smoke(arch)
    cpu = loop.init_state(cfg, 3, "cpu")
    model = transformer.Transformer(cfg, cuda)
    model.load_state_dict(cpu.model.state_dict())
    card = loop.TrainState(model.requires_grad_(True),
                           optimizer.init(dict(model.named_parameters())))
    batch = pipeline.synthetic_batch(cfg, pipeline.DataConfig(2, 24), 0)
    grads = {}
    for name, state in (("cpu", cpu), ("card", card)):
        loss, _ = loop.loss_fn(state.model, pipeline.to_tensors(batch, state.model.embed.device))
        loss.backward()
        grads[name] = {n: p.grad.cpu() for n, p in state.model.named_parameters()
                       if p.grad is not None}
    assert grads["cpu"].keys() == grads["card"].keys()
    for n, want in grads["cpu"].items():
        err = (grads["card"][n] - want).pow(2).mean().sqrt()
        assert err <= 1e-4 * want.pow(2).mean().sqrt() + 1e-12, n
    before = dict(ops.LAUNCHES)
    step = loop.make_train_step(cfg)
    (cpu, m_cpu), (card, m_card) = (step(s, pipeline.to_tensors(batch, s.model.embed.device))
                                    for s in (cpu, card))
    assert ops.LAUNCHES == before
    for k in ("loss", "nll", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(m_card[k].item(), m_cpu[k].item(), rtol=1e-5, atol=1e-7)
    for (n, p), q in zip(cpu.model.named_parameters(), card.model.parameters()):
        np.testing.assert_allclose(q.detach().cpu().numpy(), p.detach().numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=n)


@pytest.mark.gpu
def test_sharded_paths_on_two_ranks_sharing_the_card(cuda):
    """A world of 2 gloo ranks on the one card: Ulysses through K1 and the
    chunk-parallel scan through K3 (each rank launching its kernel), at the
    smoke shapes, against the kernels unsharded on the same inputs."""
    from repro_torch.kernels import _build
    from repro_torch.launch import shard_check as sc
    _build.build()                      # the ranks load it; none builds it
    attn = [sc.AttnCase("causal", 2, 256, 4, 64, causal=True, dtype="bfloat16", seed=1),
            sc.AttnCase("bidir", 1, 192, 2, 128, dtype="bfloat16", seed=2)]
    scan = [sc.ScanCase("rwkv6", 1, 4, 256, 64, 64, True, dtype="bfloat16", seed=3),
            sc.ScanCase("zamba2", 1, 4, 256, 64, 64, False, layout="zamba2",
                        dtype="bfloat16", seed=4)]
    res = sc.run(2, sc.suite_ranks, attn, scan, device="cuda", threads=0)
    assert [r["ulysses"]["launches"]["flash_attention"] for r in res] == [len(attn)] * 2
    assert [r["scan"]["launches"]["ssm_scan"] for r in res] == [2 * len(scan)] * 2
    for case, got in zip(attn, res[0]["ulysses"]["outputs"]):
        q, k, v = sc.attn_inputs(case, "cuda")
        _assert_attention_close(got.cuda(), tfa.flash_attention(q, k, v, causal=case.causal))
    for case, (out, state) in zip(scan, res[0]["scan"]["outputs"]):
        q, k, v, decay, bonus = sc.scan_inputs(case, "cuda")
        want_out, want_state = tss.ssm_scan(q, k, v, decay, bonus=bonus)
        torch.testing.assert_close(out.cuda().float(), want_out.float(), atol=BF16_TOL,
                                   rtol=BF16_TOL)
        torch.testing.assert_close(state.cuda(), want_state, atol=1e-4, rtol=1e-4)
