"""The limits of ``chip_smoke.py`` hold what they claim, on the CPU.

K1's check must pass a kernel that differs from the plain version only by
K1's own rounding, and reject one that lets the zero padding of its ragged
last KV tile in, one that forgets to rescale its accumulator, and one whose
ring of K/V stages slips by a tile. Phase 4's limit on the DiT's output must
sit above what bf16 itself gives and below what a wiring fault gives. The
rounding model below is K1's arithmetic in plain PyTorch: f32 scores per
128-key tile, scaled by scale * log2(e) in f32, an online softmax in base 2
with f32 running max and sum, and the unnormalised probabilities rounded to
bf16 before the P V product.

  PYTHONPATH=src python -m pytest -s tests/test_torch_smoke_checks.py

prints each reading.
"""
import dataclasses
import importlib.util
import math
import os
from types import SimpleNamespace

import pytest
import torch

import repro_torch.configs as C
from repro_torch.kernels import adaln_rmsnorm as tar
from repro_torch.kernels import ref
from repro_torch.models import diffusion

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)


K1_FAULTS = ("acc not rescaled", "P times the previous tile's V")


def k1_rounding_model(q, k, v, pad_keys=False, causal=False, fault=None):
    """K1's arithmetic on the CPU; ``pad_keys`` lets the last tile's zero
    padding in at score 0, as a kernel without the ragged-edge mask would;
    ``fault`` is one of K1_FAULTS: the accumulator not rescaled when the row
    max moves, or each tile's P multiplied by the V its ring stage held one
    tile before (the first tile's own V for the first)."""
    b, lq, h, d = q.shape
    bn = smoke.K1_BN
    if pad_keys:
        pad = -k.shape[1] % bn
        k, v = (torch.cat([t, t.new_zeros((b, pad, h, d))], 1) for t in (k, v))
    qf, kf, vf = q.float(), k.float(), v.float()
    # the kernel's f32 product of the scale (a C float) and log2(e)
    sl2 = torch.tensor(1.0 / math.sqrt(d)) * torch.tensor(math.log2(math.e))
    m = torch.full((b, h, lq, 1), -math.inf)
    lsum = torch.zeros((b, h, lq, 1))
    acc = torch.zeros((b, h, lq, d))
    for k0 in range(0, k.shape[1], bn):
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf[:, k0:k0 + bn]) * sl2
        if causal:                       # the reference's mask value, as K1 keeps it
            kpos = torch.arange(k0, k0 + s.shape[-1])
            s = torch.where(kpos[None, :] <= torch.arange(lq)[:, None], s,
                            torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        lsum = alpha * lsum + p.sum(-1, keepdim=True)
        v0 = max(0, k0 - bn) if fault == K1_FAULTS[1] else k0
        pv = torch.einsum("bhqk,bkhd->bhqd", p.bfloat16().float(), vf[:, v0:v0 + s.shape[-1]])
        acc = (acc if fault == K1_FAULTS[0] else acc * alpha) + pv
        m = m_new
    return (acc / lsum).permute(0, 2, 1, 3).bfloat16()


def _k1_inputs(length):
    g = torch.Generator().manual_seed(length)
    return [torch.randn((1, length, 4, 64), generator=g).bfloat16() for _ in range(3)]


@pytest.mark.parametrize("length", smoke.K1_FAULT_SHOWN)
def test_k1_check_passes_rounding_and_rejects_the_padded_key_fault(length):
    q, k, v = _k1_inputs(length)
    want = ref.attention_ref(q, k, v)
    err, rel, ok = smoke.k1_agree(k1_rounding_model(q, k, v), want)
    print(f"L={length} rounding: max err {err:.5f}, rms err / rms {rel:.5f}")
    assert ok and rel < smoke.K1_RMS / 1.4
    err, rel, ok = smoke.k1_agree(k1_rounding_model(q, k, v, pad_keys=True), want)
    print(f"L={length} padded-key fault: max err {err:.5f}, rms err / rms {rel:.5f}")
    assert not ok


def test_k1_padded_key_fault_at_cogvideox_length_is_below_the_limits():
    """Why K1_FAULT_SHOWN leaves out cogvideox's L = 7277: its ragged tile
    pads only 19 keys, and letting them in moves the output by less than
    K1's limits allow (so phase 3 does not ask its check to see it)."""
    length = 7277
    assert length not in smoke.K1_FAULT_SHOWN and -length % smoke.K1_BN == 19
    q, k, v = _k1_inputs(length)
    want = ref.attention_ref(q, k, v)
    err, rel, ok = smoke.k1_agree(k1_rounding_model(q, k, v, pad_keys=True), want)
    print(f"L={length} padded-key fault: max err {err:.5f}, rms err / rms {rel:.5f}")
    assert ok and rel < smoke.K1_RMS


@pytest.mark.parametrize("fault", K1_FAULTS)
@pytest.mark.parametrize("length", [1101, 4173])
def test_k1_check_rejects_the_redesigns_faults(length, fault):
    """Two faults a pipelined, register-resident K1 can introduce."""
    q, k, v = _k1_inputs(length)
    want = ref.attention_ref(q, k, v)
    err, rel, ok = smoke.k1_agree(k1_rounding_model(q, k, v, fault=fault), want)
    print(f"L={length} {fault}: max err {err:.5f}, rms err / rms {rel:.5f}")
    assert not ok


def test_k1_check_passes_causal_rounding_in_the_early_rows():
    """Zamba2's causal prefill (B=4, 32 heads of 64): the first rows average
    a few values of magnitude ~1, where rounding the probabilities at K1's
    place and at the plain version's differs by up to one bf16 ulp of those
    values. The per-row floor passes that; a floor on the whole output's rms
    would fail ~100 elements here (as it failed the card's at L=1810)."""
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn((4, 256, 32, 64), generator=g).bfloat16() for _ in range(3))
    want = ref.attention_ref(q, k, v, torch.ones(256, 256, dtype=torch.bool).tril())
    err, rel, ok = smoke.k1_agree(k1_rounding_model(q, k, v, causal=True), want)
    print(f"causal L=256 rounding: max err {err:.5f}, rms err / rms {rel:.5f}")
    assert ok and rel < smoke.K1_RMS / 1.4


def _rms_rel(got, want):
    return ((got - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt()).item()


@pytest.mark.parametrize("pipeline", ["sd3", "flux", "cogvideox"])
def test_dit_limit_sits_between_bf16_rounding_and_wiring_faults(monkeypatch, pipeline):
    """Two full-width DiT layers (sd3's 24 heads of 64 at d1536; flux's 24
    of 128 at d3072, as hunyuanvideo's; cogvideox's 48 of 64 at d3072),
    modulation filled as the smoke fills it: bf16 against f32 on the same
    weights reads well under EPS_TOL, and each wiring fault in the f32 model
    moves the output above it."""
    cfg = dataclasses.replace(C.get(pipeline).dit, num_layers=2)
    torch.manual_seed(0)
    bf = diffusion.DiT(cfg, "cpu")
    bf.init_(torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for w in [layer.mod for layer in bf.layers] + [bf.final_mod]:
            w.copy_(torch.randn(w.shape, generator=g) * 0.02)
    f32 = diffusion.DiT(dataclasses.replace(cfg, dtype=torch.float32), "cpu")
    with torch.no_grad():
        for pf, pb in zip(f32.parameters(), bf.parameters()):
            pf.copy_(pb.float())
    g = torch.Generator().manual_seed(3)
    latents = torch.randn((1, 256, cfg.latent_dim), generator=g)
    cond = torch.randn((1, 77, cfg.cond_dim), generator=g)
    t = torch.tensor([500.0])
    with torch.no_grad():
        want = f32(latents, t, cond)
        rounding = _rms_rel(bf(latents, t, cond), want)
        print(f"{pipeline} bf16 vs f32: {rounding:.5f}")
        assert rounding < smoke.EPS_TOL / 1.5
        attention = diffusion.kops.flash_attention
        norm = diffusion.kops.adaln_rmsnorm
        faults = {
            "attention zeroed": (lambda q, k, v, **kw: torch.zeros_like(q), norm),
            "heads swapped": (lambda q, k, v, **kw: attention(q, k, v, **kw).flip(2), norm),
            "keys shifted one row": (
                lambda q, k, v, **kw: attention(q, k.roll(1, 1), v, **kw), norm),
            "scale and shift swapped": (
                attention, lambda x, s, sh, eps=1e-6: norm(x, sh, s, eps=eps)),
        }
        for name, (fa, an) in faults.items():
            monkeypatch.setattr(diffusion.kops, "flash_attention", fa)
            monkeypatch.setattr(diffusion.kops, "adaln_rmsnorm", an)
            moved = _rms_rel(f32(latents, t, cond), want)
            print(f"{pipeline} {name}: {moved:.5f}")
            assert moved > smoke.EPS_TOL, name


def _fast_dense_init_(w, gen, scale=1.0, fan_in=None):
    """``common.dense_init_``'s truncated normal, drawn by rejection: the
    same distribution, at a fraction of ``trunc_normal_``'s CPU time."""
    t = torch.randn(w.shape, generator=gen)
    bad = t.abs() > 2.0
    while bad.any():
        t[bad] = torch.randn(int(bad.sum()), generator=gen)
        bad = t.abs() > 2.0
    w.copy_(t * (scale / math.sqrt(max(1, w.shape[0] if fan_in is None else fan_in))))


def _llm_cut_models(arch, monkeypatch):
    """Phase 7's cut of ``arch`` in bf16 (weights from a seed) and the same
    weights in float32, both on the CPU."""
    from repro_torch.models import common, transformer
    cfg = smoke.llm_cut_config(C, arch)
    bf = transformer.Transformer(cfg, "cpu").eval()
    with monkeypatch.context() as m:
        m.setattr(common, "dense_init_", _fast_dense_init_)
        bf.init_(torch.Generator().manual_seed(11))
    f32 = transformer.Transformer(dataclasses.replace(cfg, dtype=torch.float32), "cpu").eval()
    with torch.no_grad():
        for pf, pb in zip(f32.parameters(), bf.parameters()):
            pf.copy_(pb.float())
    return cfg, bf, f32


@pytest.mark.parametrize("arch", smoke.LLM_ARCHS)
def test_llm_cut_limits_sit_between_bf16_rounding_and_faults(arch, monkeypatch):
    """Phase 7's readings of bf16 against f32 on the same weights sit well
    under their limits, and a fault in the f32 model's scan moves at least
    one reading above its limit. (Dropping zamba2's causal mask barely moves
    them: with random weights the attention's output is small; phase 3
    holds K1's causal mask at these shapes.)"""
    from repro_torch.kernels import ops
    cfg, bf, f32 = _llm_cut_models(arch, monkeypatch)
    prompt, steps = smoke.llm_cut_inputs(torch, cfg)
    want = smoke.llm_cut_readout(torch, f32, prompt, steps)
    got = smoke.llm_cut_readout(torch, bf, prompt, steps)
    for key in want:        # the readings the model has: SSM states, K/V caches
        tol = smoke.LLM_CUT_TOL[key]
        reading = smoke.rms_rel(got[key], want[key])
        print(f"{arch} bf16 vs f32, {key}: {reading:.5f}")
        assert reading < tol / 1.5, key
    del bf
    scan = ops.linear_scan
    if arch == "rwkv6-3b":
        name = "scan without its bonus term"

        def fault(q, k, v, decay, *, bonus=None, initial_state=None):
            return scan(q, k, v, decay, bonus=torch.zeros_like(bonus),
                        initial_state=initial_state)
    else:
        name = "scan reads one token late"

        def fault(q, k, v, decay, *, bonus=None, initial_state=None):
            return ref.ssm_scan_ref(q, k, v, decay, torch.zeros((q.shape[1], q.shape[3])),
                                    initial_state)
    monkeypatch.setattr(ops, "linear_scan", fault)
    moved = smoke.llm_cut_readout(torch, f32, prompt, steps)
    readings = {k: smoke.rms_rel(moved[k], want[k]) for k in want}
    print(f"{arch} {name}: {readings}")
    assert any(readings[k] > smoke.LLM_CUT_TOL[k] for k in readings), name


def _fma(a, b, c):
    """f32 fused multiply-add: the exact product and sum in f64, rounded once
    to f32 (the f64 sum's own rounding is far below f32's)."""
    return (a.double() * b.double() + c.double()).float()


def k3_order_model(q, k, v, decay, bonus=None, rows=8, fault=None):
    """K3's arithmetic on the CPU, in f32: per token and state element the
    kernel's FMAs (kv = k v; strict: part += q (u kv + S), S = w S + kv;
    inclusive: S = w S + kv, part += q S) on the clamped decay, with the read
    summed in the kernel's order over K: each of the 64 / rows threads of a
    column group chains its rows (csrc/ssm_scan.cu ``row_of``), neighbours
    (sub, sub ^ 1) and then (sub, sub ^ 2) add their partials, and the sums
    of the 4-thread groups are added in order.
    ``fault``: "stage slip" (token t reads k and v of token t - CHUNK, as a
    ring whose stage index slips by one chunk would), "unclamped decay"."""
    subs = 64 // rows
    idx = torch.tensor([[4 * s + 4 * subs * (j // 4) + j % 4 if rows >= 4 else rows * s + j
                         for j in range(rows)] for s in range(subs)])
    b, h, l, dk = q.shape
    pad = lambda t: torch.nn.functional.pad(t.float(), (0, 64 - t.shape[-1]))
    qf, kf, vf = pad(q), pad(k), v.float()
    wf = decay.float() if fault == "unclamped decay" else ref.clamp_decay(decay)
    wf = torch.nn.functional.pad(wf, (0, 64 - dk), value=1.0)
    if fault == "stage slip":
        from repro_torch.kernels import ssm_scan as ss
        shift = lambda t: torch.cat([t[:, :, :ss.CHUNK], t[:, :, :-ss.CHUNK]], 2)
        kf, vf = shift(kf), shift(vf)
    u = None if bonus is None else pad(bonus)[None, :, :, None].expand(b, h, 64, 1)
    s = torch.zeros((b, h, 64, v.shape[-1]))
    outs = []
    for t in range(l):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]
        w = wf[:, :, t, :, None]
        if u is not None:
            read, s = _fma(u, kv, s), _fma(w, s, kv)
        else:
            s = _fma(w, s, kv)
            read = s
        qt = qf[:, :, t][:, :, idx]                   # (B, H, SUBS, R)
        rd = read[:, :, idx]                          # (B, H, SUBS, R, V)
        part = torch.zeros(rd.shape[:3] + rd.shape[4:])
        for j in range(rows):
            part = _fma(qt[:, :, :, j, None], rd[:, :, :, j], part)
        pairs = part[:, :, 0::2] + part[:, :, 1::2]
        quads = pairs[:, :, 0::2] + pairs[:, :, 1::2]
        acc = quads[:, :, 0]
        for m in range(1, subs // 4):
            acc = acc + quads[:, :, m]
        outs.append(acc)
    return torch.stack(outs, 2).to(v.dtype), s[:, :, :dk]


def _k3_inputs(b, h, l, bonus, floor=False, seed=5):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((b, h, l, 64), generator=g) for _ in range(3))
    decay = (torch.full((b, h, l, 64), math.exp(-5.4)) if floor
             else torch.exp(-torch.exp(torch.randn((b, h, l, 64), generator=g))))
    return q, k, v, decay, torch.randn((h, 64), generator=g) if bonus else None


@pytest.mark.parametrize("rows", [2, 4, 8])
@pytest.mark.parametrize("bonus", [False, True])
@pytest.mark.parametrize("floor", [False, True])
def test_k3_limits_hold_the_kernels_order_of_sums(rows, bonus, floor):
    """K3's limits (chip_smoke.scan_agree) pass the kernel's f32 arithmetic in
    its own order of the sums over K, at (1, 2, 300, 64, 64) and at the decay
    floor, for each register tile."""
    q, k, v, decay, u = _k3_inputs(1, 2, 300, bonus, floor)
    got = k3_order_model(q, k, v, decay, u, rows=rows)
    err, state_err, ok = smoke.scan_agree(got, ref.ssm_scan_ref(q, k, v, decay, u))
    print(f"K3 order model R={rows} bonus={bonus} floor={floor}: max |err| {err:.3g}, "
          f"state {state_err:.3g}")
    assert ok and err > 0


@pytest.mark.parametrize("fault", ["stage slip", "unclamped decay"])
@pytest.mark.parametrize("bonus", [False, True])
def test_k3_limits_reject_the_rings_faults(fault, bonus):
    q, k, v, decay, u = _k3_inputs(1, 2, 300, bonus)
    got = k3_order_model(q, k, v, decay, u, rows=4, fault=fault)
    err, state_err, ok = smoke.scan_agree(got, ref.ssm_scan_ref(q, k, v, decay, u))
    print(f"K3 {fault} bonus={bonus}: max |err| {err:.3g}, state {state_err:.3g}")
    assert not ok, fault


K2_FAULTS = ("dropped lane", "dropped vector", "stale modulation", "tail vector unwritten")


def k2_model(x, scale, shift, eps=1e-6, fault=None):
    """K2's arithmetic on the CPU, in f32, in the kernel's order
    (csrc/adaln_rmsnorm.cu at ``tar.plan``'s instantiation): lane j of a row
    chains the squares of its vectors j + i * lanes (i < V, elements in
    order) by FMA, the row's lanes add their sums in a butterfly of shuffles,
    r = rsqrt(sum / D + eps), and out = fma(x * r, 1 + scale, shift).
    ``fault``: "dropped lane" (the last lane's sum left out), "dropped
    vector" (the row's last vector left out of the sum, a mask one short),
    "stale modulation" (the first block of each batch row after the first
    reads the previous batch row's scale and shift), "tail vector unwritten"
    (the row's last vector of out left as torch.empty found it: zeros)."""
    b, l, d = x.shape
    p = tar.plan(b, l, d, x.dtype)
    lanes, nv, per_vec = p["lanes"], p["vectors"], 16 // x.element_size()
    xf = x.float()
    sq = torch.nn.functional.pad(xf, (0, lanes * nv * per_vec - d))
    if fault == K2_FAULTS[1]:
        sq[..., d - per_vec:d] = 0
    sq = sq.reshape(b, l, nv, lanes, per_vec)
    part = torch.zeros((b, l, lanes))
    for i in range(nv):
        for k in range(per_vec):
            part = _fma(sq[:, :, i, :, k], sq[:, :, i, :, k], part)
    if fault == K2_FAULTS[0]:
        part[..., -1] = 0
    idx = torch.arange(lanes)
    off = lanes // 2
    while off:
        part = part + part[..., idx ^ off]
        off //= 2
    r = torch.rsqrt(part[..., :1] / d + eps)
    s, t = scale.float()[:, None, :].repeat(1, l, 1), shift.float()[:, None, :].repeat(1, l, 1)
    if fault == K2_FAULTS[2]:
        rows = p["rows_per_block"]
        s[1:, :rows], t[1:, :rows] = s[:-1, :rows].clone(), t[:-1, :rows].clone()
    out = _fma(xf * r, 1.0 + s, t)
    if fault == K2_FAULTS[3]:
        out[..., d - per_vec:] = 0
    return out.to(x.dtype)


def _k2_inputs(b, l, d, dtype, seed=7):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, l, d), generator=g).to(dtype)
    mod = (torch.randn((b, 6, d), generator=g) * 0.1).to(dtype)
    return x, mod[:, 0], mod[:, 1]


def _k2_check(got, x, s, t):
    name = str(x.dtype).split(".")[-1]
    return smoke.agree(got, ref.adaln_rmsnorm_ref(x, s, t), smoke.K2_TOL[name])


@pytest.mark.parametrize("d", [1536, 3072])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l", [(1, 101), (3, 45)])
def test_k2_limits_pass_the_kernels_order_of_sums(b, l, d, dtype):
    """K2's limits pass its f32 arithmetic in its own order at the served
    widths, with the plain version's rounding to bf16 where it applies."""
    x, s, t = _k2_inputs(b, l, d, dtype)
    err, ok = _k2_check(k2_model(x, s, t), x, s, t)
    print(f"K2 order model {b}x{l}x{d} {dtype}: max |err| {err:.3g}")
    assert ok


@pytest.mark.parametrize("fault", K2_FAULTS[:2])
@pytest.mark.parametrize("d", [1536, 3072])
def test_k2_float32_check_rejects_a_sum_that_drops_a_share(fault, d):
    """A sum of squares short of one lane's or one vector's share scales a
    row by 1/sqrt(1 - share): on average ~1.6% for a lane at D = 1536, 0.1-0.3%
    for a vector. The bf16 limit (2e-2 + 2e-2 |plain|) need not see that (it is
    printed); the float32 check at the same width (1e-5) rejects it."""
    for dtype in (torch.bfloat16, torch.float32):
        x, s, t = _k2_inputs(1, 101, d, dtype)
        err, ok = _k2_check(k2_model(x, s, t, fault=fault), x, s, t)
        print(f"K2 {fault} D={d} {dtype}: max |err| {err:.3g}, passes: {ok}")
    assert not ok, fault


@pytest.mark.parametrize("fault", K2_FAULTS[2:])
@pytest.mark.parametrize("b,l,d", smoke.K2_BATCHED)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_checks_reject_a_stale_modulation_row_and_an_unwritten_tail(fault, b, l, d, dtype):
    """At chip_smoke's batched shapes both limits reject a block that reads
    the previous batch row's modulation and a row whose last vector is never
    stored."""
    x, s, t = _k2_inputs(b, l, d, dtype)
    err, ok = _k2_check(k2_model(x, s, t, fault=fault), x, s, t)
    print(f"K2 {fault} {b}x{l}x{d} {dtype}: max |err| {err:.3g}")
    assert not ok


# -- phase 10: the simulated H100 fleet --------------------------------------------

@pytest.fixture(scope="module")
def fleet_result():
    from repro_torch.core.fleet import FleetConfig, run_fleet
    return run_fleet(["sd3", "flux"], mode="adaptive", duration=60.0,
                     rates={"sd3": 4.0, "flux": 0.4}, cfg=FleetConfig(num_chips=16))


@pytest.mark.parametrize("field,value", [("p95_latency", 1e9), ("sched_wakeups", -1),
                                         ("repartitions", []), ("prewarm_units", 7),
                                         ("engine_stats", {})])
def test_fleet_rerun_check_rejects_one_changed_field(fleet_result, field, value):
    """Phase 10's determinism check passes an identical second run and names
    the one field a second run changed."""
    smoke.same_result(fleet_result, dataclasses.replace(fleet_result), "cell")
    with pytest.raises(RuntimeError, match=field):
        smoke.same_result(fleet_result, dataclasses.replace(fleet_result, **{field: value}),
                          "cell")


def test_fleet_phase_runs_at_a_cut_size_and_prints_a_row_per_mode(tmp_path, monkeypatch,
                                                                     capsys):
    import json
    monkeypatch.setattr(smoke, "out_path", lambda name: str(tmp_path / name))
    rows, by_cell = smoke.fleet_phase(chips=16, duration=120.0)
    printed = [json.loads(line[len("[10] "):]) for line in capsys.readouterr().out.splitlines()
               if line.startswith("[10] {")]
    assert printed == rows == json.loads((tmp_path / "fleet.json").read_text())
    assert [(s, hw, r.mode) for (s, hw), runs in by_cell.items() for r in runs] == \
        [(r["scenario"], r["hw"], r["mode"]) for r in rows]
    assert [(r["scenario"], r["mode"], r["hw"]) for r in rows] == [
        ("shared", "static", "h100"), ("shared", "proportional", "h100"),
        ("shared", "adaptive", "h100"), ("shared", "predictive", "h100"),
        ("predictive", "adaptive", "h100"), ("predictive", "predictive", "h100"),
        ("cross_batch", "off", "h100"), ("cross_batch", "batching", "h100"),
        ("lending", "adaptive", "h100"), ("lending", "adaptive+lending", "h100"),
        ("elastic", "drain_aware", "h100"), ("elastic", "drain_unaware", "h100"),
        ("elastic", "drain_aware", "reference"), ("elastic", "drain_unaware", "reference")]
    # one node of 8 chips per pipeline: the three-pipeline pool is cut to 24
    assert [r["chips"] for r in rows] == [24] * 4 + [16] * 10
    assert {r["duration_s"] for r in rows} == {120.0}
    assert all(r["slo_pct"] >= 0.0 and r["host_s"] > 0.0 for r in rows)
    assert all(r["diffuse_runs_on_borrowed_units"] == 0 for r in rows)
    assert [r["recovery_p95_s"] is not None for r in rows] == [False] * 10 + [True] * 4


# -- phase 11: the host path's fast paths -----------------------------------------

def _small_phase11(monkeypatch, tmp_path):
    """Phase 11 at a cut size: phase 10's cells at 16 chips and 120 s, one
    small elastic cell for the uncut ones, and a 64-chip, 1500-request scale
    tier whose reference fields come from the reference's own scale run
    (``benchmarks/e2e.py``)."""
    import contextlib
    import io
    from benchmarks import e2e
    from repro_torch.launch import scale
    monkeypatch.setattr(smoke, "out_path", lambda name: str(tmp_path / name))
    monkeypatch.setattr(scale, "SMOKE_CHIPS", 64)
    monkeypatch.setattr(scale, "SMOKE_REQUESTS", 1500)
    monkeypatch.setattr(smoke, "UNCUT_SCENARIOS", (
        ("elastic", ["--smoke", "--chips", "16", "--rate-scale", "0.125"], 16, 120.0),))
    want = e2e._time_scale_tree(ROOT, 64, 1500, True, 1, "reference")
    monkeypatch.setattr(smoke, "SCALE_REFERENCE", {
        "n_requests": want["n_requests"], "n_finished": want["n_finished"],
        "slo": want["slo"], "sched_wakeups": want["wakeups"],
        "repartitions": want["repartitions"]})
    with contextlib.redirect_stdout(io.StringIO()):
        _, by_cell = smoke.fleet_phase(chips=16, duration=120.0)
    return by_cell


def test_fast_phase_runs_at_a_cut_size_and_checks_its_cells(tmp_path, monkeypatch, capsys):
    """Phase 11 prints a row per mode of phase 10's cells with both host
    times, each conserving phase 10's requests, and the uncut, scale and
    cross-node rows; the scale tier on the reference's constants must give
    the reference's fields, and a mode that finishes other requests
    than its phase-10 run fails the phase."""
    import json
    by_cell = _small_phase11(monkeypatch, tmp_path)
    rows = smoke.fast_phase(by_cell, chips=16, duration=120.0)
    printed = [json.loads(line[len("[11] "):]) for line in capsys.readouterr().out.splitlines()
               if line.startswith("[11] {")]
    assert printed == json.loads(json.dumps(rows)) == \
        json.loads((tmp_path / "fast.json").read_text())
    fleet = [r for r in rows if "cell" not in r]
    assert [(r["scenario"], r["hw"], r["mode"]) for r in fleet] == \
        [(s, hw, r.mode) for (s, hw), runs in by_cell.items() for r in runs]
    for r in fleet:
        base = next(b for b in by_cell[r["scenario"], r["hw"]] if b.mode == r["mode"])
        assert (r["n_requests"], r["n_finished"]) == (base.result.n_requests,
                                                      base.result.n_finished)
        assert r["fast"] and r["phase10_host_s"] == base.wall_s and r["host_s"] > 0.0
    assert [r["cell"] for r in rows if "cell" in r] == [
        "uncut", "uncut", "scale", "scale", "cross_node_sp", "node_sp"]
    assert max(rows[-2]["degree_histogram"]) > max(rows[-1]["degree_histogram"])
    # a phase-10 run that finished one request fewer: conservation fails
    cell = next(iter(by_cell))
    bad = [dataclasses.replace(r, result=dataclasses.replace(
        r.result, n_finished=r.result.n_finished - 1)) for r in by_cell[cell]]
    with pytest.raises(RuntimeError, match="finished"):
        smoke.fast_phase({**by_cell, cell: bad}, chips=16, duration=120.0)


def test_fast_phase_rejects_scale_fields_other_than_the_references(tmp_path, monkeypatch):
    by_cell = _small_phase11(monkeypatch, tmp_path)
    monkeypatch.setattr(smoke, "SCALE_REFERENCE",
                        {**smoke.SCALE_REFERENCE, "sched_wakeups": -1})
    with pytest.raises(RuntimeError, match="scale tier"):
        smoke.fast_phase(by_cell, chips=16, duration=120.0)


def _fleet_run(result, scenario="lending", mode="adaptive+lending", recovery=None):
    return SimpleNamespace(scenario=scenario, mode=mode, result=result, recovery=recovery)


def test_fleet_checks_reject_a_diffuse_run_on_a_borrowed_unit(fleet_result):
    """Phase 10 fails on a Diffuse stage on a borrowed unit, whatever the
    scenario, and passes E/C runs on borrowed units."""
    lent = dataclasses.replace(fleet_result, loans=3, borrowed_stage_runs={"C": 5, "E": 1})
    smoke.check_fleet_run(_fleet_run(lent), "h100")
    bad = dataclasses.replace(lent, borrowed_stage_runs={"C": 5, "D": 1})
    with pytest.raises(RuntimeError, match="Diffuse"):
        smoke.check_fleet_run(_fleet_run(bad), "h100")
    with pytest.raises(RuntimeError, match="Diffuse"):
        smoke.check_fleet_run(_fleet_run(bad, "elastic", "drain_aware"), "reference")


def test_fleet_checks_reject_a_loss_without_requeues_on_the_reference_constants(
        fleet_result):
    """The drain-unaware arm on the reference's constants must requeue work
    when it loses nodes; the drain-aware arm, a loss-free run and the
    H100_SXM run (whose lost nodes hold no work) pass without."""
    lost = dataclasses.replace(fleet_result, nodes_lost=2, requeued_requests=0)
    with pytest.raises(RuntimeError, match="nothing requeued"):
        smoke.check_fleet_run(_fleet_run(lost, "elastic", "drain_unaware"), "reference")
    smoke.check_fleet_run(_fleet_run(lost, "elastic", "drain_aware"), "reference")
    smoke.check_fleet_run(_fleet_run(lost, "elastic", "drain_unaware"), "h100")
    smoke.check_fleet_run(_fleet_run(dataclasses.replace(lost, requeued_requests=4),
                                     "elastic", "drain_unaware"), "reference")
    smoke.check_fleet_run(_fleet_run(fleet_result, "elastic", "drain_unaware"), "reference")


@pytest.mark.parametrize("field,value", [("loans", 7), ("borrowed_stage_runs", {"C": 1}),
                                         ("requeued_requests", 3),
                                         ("elastic_prewarm_chips", 8),
                                         ("recovery_p95_s", (9.5, 12))])
def test_fleet_rerun_check_rejects_a_changed_lending_or_elastic_field(fleet_result, field,
                                                                      value):
    """A second run of a lending or elastic arm must repeat every field the
    new rows carry, the recovery-window P95 among them."""
    first = _fleet_run(fleet_result, "elastic", "drain_aware", (2.5, 12))
    smoke.same_run(first, _fleet_run(dataclasses.replace(fleet_result), "elastic",
                                     "drain_aware", (2.5, 12)), "cell")
    if field == "recovery_p95_s":
        second = _fleet_run(fleet_result, "elastic", "drain_aware", value)
    else:
        second = _fleet_run(dataclasses.replace(fleet_result, **{field: value}), "elastic",
                            "drain_aware", (2.5, 12))
    with pytest.raises(RuntimeError, match=field):
        smoke.same_run(first, second, "cell")


def _k1_cpu_inputs(b, lq, lkv, h, d, seed=3):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((b, n, h, d), generator=g) for n in (lq, lkv, lkv)]


@pytest.mark.parametrize("shape", [
    (2, 40, 40, 3, 32, True, 16, 50.0),      # gemma2's local layers: window and softcap
    (2, 40, 40, 3, 32, True, 0, 50.0),       # its global ones: the softcap alone
    (2, 40, 40, 3, 32, True, 16, 0.0),       # starcoder2's: the window alone
    (2, 40, 40, 3, 32, True, 0, 0.0),        # causal (yi, deepseek-moe, zamba2)
    (1, 20, 50, 3, 32, True, 0, 0.0),        # queries at the end of a longer kv
    (1, 40, 40, 3, 32, False, 0, 0.0),       # the DiTs'
])
def test_k1_timed_calls_compute_the_shapes_own_function(shape):
    """Phase 3 times K1, its plain version and the library call with the
    shape's own window and softcap: on the CPU (the kernel stood in for by
    the op's plain path) each computes ``ref.attention_ref`` with that mask
    and cap; a softcapped shape has no library call."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    b, lq, lkv, h, d, causal, window, cap = shape
    q, k, v = _k1_cpu_inputs(b, lq, lkv, h, d)
    mask = ops.attention_mask(lq, lkv, window, q.device) if causal else None
    fa = SimpleNamespace(flash_attention=ops.flash_attention)
    kernel, plain, library = smoke.k1_calls(F, fa, ref, causal, window, cap, mask)
    want = ref.attention_ref(q, k, v, mask, cap)
    torch.testing.assert_close(kernel(q, k, v), want, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(plain(q, k, v), want, atol=1e-6, rtol=1e-6)
    if cap > 0.0:
        assert library is None
    else:
        torch.testing.assert_close(library(q, k, v), want, atol=1e-5, rtol=1e-5)


def test_serving_shapes_come_from_each_llm_config():
    groups = {"zamba2-1.2b": [1810], "yi-34b": [854], "starcoder2-15b": [5877],
              "gemma2-9b": [5877, 5975]}
    k1, _ = smoke.serving_shapes(C, groups)
    llm = [(path, shape) for path, shape in k1 if path in groups]
    assert llm == [
        ("zamba2-1.2b", (4, 1810, 1810, 32, 64, True, 0, 0.0)),
        ("yi-34b", (4, 854, 854, 56, 128, True, 0, 0.0)),
        ("starcoder2-15b", (4, 5877, 5877, 48, 128, True, 4096, 0.0)),
        ("gemma2-9b", (4, 5877, 5877, 16, 256, True, 4096, 50.0)),
        ("gemma2-9b", (4, 5877, 5877, 16, 256, True, 0, 50.0)),
        ("gemma2-9b", (4, 5975, 5975, 16, 256, True, 4096, 50.0)),
        ("gemma2-9b", (4, 5975, 5975, 16, 256, True, 0, 50.0)),
    ]


@pytest.mark.parametrize("arch,k1,k3", [
    ("rwkv6-3b", 0, 32), ("zamba2-1.2b", 6, 32), ("yi-9b", 48, 0), ("yi-34b", 60, 0),
    ("deepseek-moe-16b", 28, 0), ("starcoder2-15b", 40, 0), ("gemma2-9b", 42, 0),
])
def test_expected_llm_launches_count_local_layers(arch, k1, k3):
    for lengths in ([1810], [1810, 854]):
        groups = len(lengths)
        assert smoke.expected_launches(C.get(arch), lengths) == {
            "flash_attention": k1 * groups, "adaln_rmsnorm": 0, "ssm_scan": k3 * groups}


def test_phase_8_launches_add_up_to_the_prediction():
    served = smoke.LLM_ARCHS + smoke.ATTN_ARCHS
    k1 = sum(smoke.expected_launches(C.get(a), [1810, 854])["flash_attention"] for a in served)
    assert k1 == 12 + 436 and set(smoke.LONG_ARCHS) <= set(served)


def test_llm_cuts_keep_two_layers_of_each_kind_and_a_short_window():
    kinds = {arch: smoke.llm_cut_config(C, arch).plan_kinds() for arch in smoke.ATTN_ARCHS}
    assert kinds["gemma2-9b"] == (("attn_local", "dense"), ("attn", "dense"))
    assert kinds["deepseek-moe-16b"] == (("attn", "dense"), ("attn", "moe"))
    assert kinds["starcoder2-15b"] == (("attn_local", "dense"),) * 2
    for arch in ("starcoder2-15b", "gemma2-9b"):
        assert smoke.llm_cut_config(C, arch).window_size == smoke.CUT_WINDOW < smoke.CUT_PROMPT
    assert smoke.llm_cut_config(C, "yi-34b").window_size == C.get("yi-34b").window_size


def test_phase_8b_prompts_pass_the_window():
    from repro_torch.launch import serve_llm
    for arch in smoke.LONG_ARCHS:
        cfg = C.get(arch)
        reqs = smoke.llm_requests(serve_llm, cfg)
        assert len(reqs) == 8 and min(r.prompt.shape[0] for r in reqs) > cfg.window_size
    reqs = smoke.llm_requests(serve_llm, C.get("yi-9b"))
    assert max(r.prompt.shape[0] for r in reqs) <= smoke.LLM_LENGTHS[1]


def test_kernel_records_sum_the_library_time_of_the_shapes_that_have_one():
    def row(shape, ms, lib, path):
        return {"shape": shape, "ms": ms, "plain_ms": 10 * ms, "bound_ms": ms / 2,
                "bound_by": "operations", "library_ms": lib, "max_abs_err": 0.01,
                "main_path": path}
    records = {
        "flash_attention": [row([4, 854, 854, 32, 128], 1.0, 1.5, "yi-9b"),
                            row([4, 5877, 5877, 16, 256], 2.0, None, "gemma2-9b"),
                            dict(row([1, 1, 1, 4, 256], 9.0, None, None), main_path=None)],
        "adaln_rmsnorm": [row([1, 1101, 1536], 0.1, None, "sd3")],
        "ssm_scan": [row([4, 40, 854, 64, 64], 0.5, None, "rwkv6-3b")],
    }
    by_path = {"yi-9b": {"flash_attention": 96, "adaln_rmsnorm": 0, "ssm_scan": 0},
               "gemma2-9b": {"flash_attention": 84, "adaln_rmsnorm": 0, "ssm_scan": 0},
               "sd3": {"flash_attention": 0, "adaln_rmsnorm": 2940, "ssm_scan": 0},
               "rwkv6-3b": {"flash_attention": 0, "adaln_rmsnorm": 0, "ssm_scan": 64}}
    k1, k2, k3 = smoke.kernel_records(records, by_path)
    assert k1["library_ms"] == 1.5 and k1["library_missing"] == [[4, 5877, 5877, 16, 256]]
    assert k1["ms"] == 3.0 and k1["launches"] == 180
    assert k1["ms_by_head_dim"] == {"128": 1.0, "256": 2.0}
    assert k1["ms_by_path"] == {"yi-9b": 1.0, "gemma2-9b": 2.0}
    assert k2["library_ms"] is None and k2["library_missing"] is None
    assert k3["launches"] == 64 and k3["ms_by_head_dim"] is None


def test_flash_attention_ab_reads_ptxas_and_builds_a_trapping_copy():
    from repro_torch.kernels import _build
    from repro_torch.launch import flash_attention_ab as ab
    log = ("ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113fa_fwd_kernelILi256ELi1EE"
           "Ev14CUtensorMap_st' for 'sm_90a'\n"
           "ptxas info    : Function properties for _ZN12_GLOBAL__N_113fa_fwd_kernelILi256ELi1EE\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 240 registers, used 16 barriers\n")
    assert ab.ptxas_lines(log) == [
        "D=256 NC=1: 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "D=256 NC=1: Used 240 registers, used 16 barriers"]
    source = (_build.CSRC / "flash_attention.cu").read_text()
    trap = ab.trapping(source)
    assert trap.count('asm volatile("trap;")') == 1 and source.count("trap;") == 0
    with pytest.raises(ValueError, match="poll loop"):
        ab.trapping(trap)


@pytest.mark.parametrize("length", [300, 1101])
def test_k1_row_subset_reads_the_edges_of_the_query_tiles(length):
    rows = smoke.k1_rows(length, seed=length)
    bm = smoke.K1_BM
    tiles = -(-length // bm)
    mid = tiles // 2 * bm
    assert set(range(bm)) <= set(rows)                                   # the first tile
    assert set(range(mid - bm // 2, min(length, mid + bm // 2))) <= set(rows)   # a middle edge
    assert set(range((tiles - 1) * bm, length)) <= set(rows)             # the ragged last tile
    assert rows == sorted(set(rows)) and rows[-1] == length - 1
    assert rows == smoke.k1_rows(length, seed=length)                    # seeded


@pytest.mark.parametrize("length", [300, 1101])
def test_k1_row_subset_check_passes_rounding_and_rejects_a_wrong_last_tile(length):
    """K1's check where the plain scores of every row do not fit: on the
    subset of query rows it reads, it passes the plain version and K1's
    rounding (the CPU model) and rejects a stand-in whose ragged last query tile alone is wrong (its
    rows hold the outputs of the tile before)."""
    q, k, v = _k1_inputs(length)
    rows = smoke.k1_rows(length, seed=length)
    assert smoke.k1_subset_agree(ref, ref.attention_ref(q, k, v), q, k, v, rows)[2]
    got = k1_rounding_model(q, k, v)
    err, rel, ok = smoke.k1_subset_agree(ref, got, q, k, v, rows)
    print(f"L={length} rounding on {len(rows)} rows: max err {err:.5f}, rms err / rms {rel:.5f}")
    assert ok
    last = (length - 1) // smoke.K1_BM * smoke.K1_BM
    stale = got.clone()
    stale[:, last:] = got[:, last - smoke.K1_BM:last - smoke.K1_BM + length - last]
    err, rel, ok = smoke.k1_subset_agree(ref, stale, q, k, v, rows)
    print(f"L={length} stale last tile: max err {err:.5f}, rms err / rms {rel:.5f}")
    assert not ok


def test_k1_plain_budget_keeps_every_shape_of_the_light_and_middle_classes_whole():
    """Only the heavy classes from L = 14477 on are held on a row subset:
    every shape the serve phases ran before (up to 4 x 5975 tokens) and the
    light end are held whole, as before."""
    from repro_torch.launch import serve_llm
    groups = {arch: smoke.group_lengths(smoke.llm_requests(serve_llm, C.get(arch)))
              for arch in smoke.LLM_ARCHS + smoke.ATTN_ARCHS}
    k1, _ = smoke.serving_shapes(C, groups)
    subset = {shape for path, shape in k1
              if 4 * shape[0] * 8 * shape[1] * shape[2] > smoke.K1_PLAIN_BYTES}
    assert all(path.endswith(" heavy") for path, shape in k1 if shape in subset)
    assert min(shape[1] for shape in subset) == 14477
    assert not any(shape[5] or shape[6] or shape[7] for shape in subset)


def test_serve_launches_count_layers_steps_and_classes():
    from repro_torch.launch import quickstart
    got = {}
    for name in smoke.PIPELINES:
        cfg = C.get(name)
        got[name] = smoke.serve_launches(cfg, quickstart.REQUESTS[name])
        if quickstart.HEAVY[name]:
            one = smoke.serve_launches(cfg, quickstart.HEAVY[name], num_steps=1)
            whole = smoke.serve_launches(cfg, (smoke.WHOLE_HEAVY[name],))
            got[f"{name} heavy"] = {k: one[k] + whole[k] for k in one}
    # the numbers chip_smoke.py's comment works out
    assert {k: (v["flash_attention"], v["adaln_rmsnorm"]) for k, v in got.items()} == {
        "sd3": (2400, 4900), "flux": (896, 1808), "cogvideox": (150, 306),
        "hunyuanvideo": (416, 774), "flux heavy": (392, 791),
        "cogvideox heavy": (325, 663), "hunyuanvideo heavy": (1088, 1677)}
    assert all(smoke.WHOLE_HEAVY[n] in quickstart.HEAVY[n] for n in smoke.WHOLE_HEAVY)


def test_table5_end_shapes_are_the_light_end_and_the_heavy_classes():
    k1, k2 = smoke.table5_end_shapes(C)
    lengths = sorted({shape[1] for shape in k1})
    assert len(k1) == 21 and lengths[:2] == [141, 333] and lengths[-1] == 81077
    assert (1, 7277, 7277, 48, 64, False, 0, 0.0) not in k1      # cogvideox 480 px x 2 s
    assert {(1, s[1], s[3] * s[4]) for s in k1} == k2


def test_kernel_records_split_the_sums_and_name_shapes_without_a_whole_plain_time():
    def row(shape, ms, plain, path, end):
        return {"shape": shape, "ms": ms, "plain_ms": plain, "bound_ms": ms / 2,
                "bound_by": "operations", "library_ms": 2 * ms, "max_abs_err": 0.01,
                "main_path": path, "table5_end": end}
    records = {
        "flash_attention": [row([1, 1101, 1101, 24, 64], 1.0, 10.0, "sd3", False),
                            row([1, 141, 141, 24, 64], 0.5, 5.0, "sd3", True),
                            row([1, 81077, 81077, 48, 64], 200.0, None, "cogvideox heavy", True)],
        "adaln_rmsnorm": [row([1, 1101, 1536], 0.1, 1.0, "sd3", False)],
        "ssm_scan": [row([4, 40, 854, 64, 64], 0.5, 50.0, "rwkv6-3b", False)],
    }
    by_path = {"sd3": {"flash_attention": 2400, "adaln_rmsnorm": 4900, "ssm_scan": 0},
               "cogvideox heavy": {"flash_attention": 325, "adaln_rmsnorm": 663,
                                   "ssm_scan": 0},
               "rwkv6-3b": {"flash_attention": 0, "adaln_rmsnorm": 0, "ssm_scan": 64}}
    k1, k2, _ = smoke.kernel_records(records, by_path)
    assert k1["ms"] == 201.5 and k1["plain_ms"] == 15.0 and k1["library_ms"] == 403.0
    assert k1["plain_missing"] == [[1, 81077, 81077, 48, 64]] and k1["launches"] == 2725
    ends, others = k1["sums"]["table5_ends"], k1["sums"]["others"]
    assert (ends["ms"], ends["plain_ms"], ends["bound_ms"]) == (200.5, 5.0, 100.25)
    assert ends["plain_missing"] == [[1, 81077, 81077, 48, 64]]
    assert (others["ms"], others["plain_ms"], others["plain_missing"]) == (1.0, 10.0, None)
    assert k2["sums"]["table5_ends"]["ms"] == 0 and k2["plain_missing"] is None


def _zoo_groups():
    from repro_torch.launch import serve_llm
    return {arch: smoke.group_lengths(smoke.llm_requests(serve_llm, smoke.llm_config(C, arch)))
            for arch in smoke.ZOO_ARCHS}


def test_phase_8c_requests_pass_llama4s_chunk_and_route_in_groups_of_1024():
    """llama4's prompts pass the 8192-token chunk (each group's K1 runs a
    full chunk and a ragged tail per chunked layer); each group's 4 x L
    tokens split into MoE routing groups of 1024, so the gathered expert
    batch stays near 1.4 T x D (a length with no divisor near 1024 would
    route in tiny groups: 4 x 9001 has none in [512, 1024])."""
    from repro_torch.launch import serve_llm
    from repro_torch.models import moe
    cfg = smoke.llm_config(C, smoke.LLAMA4)
    assert cfg.num_layers == 4 and [m for m, _ in cfg.layer_kinds()].count("attn_chunked") == 3
    reqs = smoke.llm_requests(serve_llm, cfg)
    assert min(r.prompt.shape[0] for r in reqs) > cfg.chunk_size
    assert all(8448 <= r.prompt.shape[0] <= 10240 for r in reqs)
    groups = smoke.group_lengths(reqs)
    assert groups == [10240, 9216]
    for g in smoke.moe_groups(cfg, moe, groups):
        assert g["s"] == 1024
        assert g["xe_bytes"] < 1.5 * g["tokens"] * cfg.d_model * 2
    tiny = smoke.moe_groups(cfg, moe, [9001])[0]
    assert tiny["s"] < 512 and tiny["xe_bytes"] > 100 * tiny["tokens"] * cfg.d_model * 2


def test_phase_8c_k1_launches_follow_the_chunks():
    """One K1 launch per chunk per chunked layer plus one per global layer
    per group for llama4 (3 x 2 + 1 = 7 a group past one chunk), one per
    layer per group for internvl2 (24) and musicgen (48)."""
    groups = _zoo_groups()
    got = {arch: smoke.expected_launches(smoke.llm_config(C, arch), lengths)
           for arch, lengths in groups.items()}
    assert {a: g["flash_attention"] for a, g in got.items()} == {
        smoke.LLAMA4: 14, "internvl2-2b": 48, "musicgen-medium": 96}
    assert all(g["ssm_scan"] == 0 == g["adaln_rmsnorm"] for g in got.values())
    one_chunk = smoke.expected_launches(smoke.llm_config(C, smoke.LLAMA4), [8192, 100])
    assert one_chunk["flash_attention"] == 8
    # internvl2's groups count the 256 patch embeddings
    assert all(l > 256 for l in groups["internvl2-2b"])


def test_phase_8c_k1_shapes_split_llama4_into_its_chunks():
    groups = _zoo_groups()
    k1, _ = smoke.serving_shapes(C, groups)
    llama = [shape for path, shape in k1 if path == smoke.LLAMA4]
    assert llama == [(4, 8192, 8192, 40, 128, True, 0, 0.0), (4, 2048, 2048, 40, 128, True, 0, 0.0),
                     (4, 10240, 10240, 40, 128, True, 0, 0.0),
                     (4, 8192, 8192, 40, 128, True, 0, 0.0), (4, 1024, 1024, 40, 128, True, 0, 0.0),
                     (4, 9216, 9216, 40, 128, True, 0, 0.0)]
    vlm = [shape for path, shape in k1 if path == "internvl2-2b"]
    assert [s[3:5] for s in vlm] == [(16, 128)] * 2 and all(s[1] > 256 for s in vlm)
    music = [shape for path, shape in k1 if path == "musicgen-medium"]
    assert [s[3:5] for s in music] == [(24, 64)] * 2
    assert all(250 <= s[1] <= 1500 for s in music)
    # llama4's full chunk and global layers pass the plain version's budget:
    # they are held on a row subset, causal
    subset = [s for s in llama if 4 * s[0] * 8 * s[1] * s[2] > smoke.K1_PLAIN_BYTES]
    assert {s[1] for s in subset} == {8192, 9216, 10240} and all(s[5] for s in subset)


@pytest.mark.parametrize("length", [300, 1101])
def test_k1_causal_row_subset_check_passes_rounding_and_rejects_a_wrong_last_tile(length):
    """The row-subset check on a causal call: each kept row is held with its
    own row of the causal mask, against every key. It passes the plain
    version and K1's rounding (the CPU model, causal) and rejects a stand-in
    whose ragged last query tile holds the tile before's outputs; it also
    rejects a kernel that dropped the mask (the non-causal outputs)."""
    from repro_torch.kernels import ops
    q, k, v = _k1_inputs(length)
    rows = smoke.k1_rows(length, seed=length)
    mask = ops.attention_mask(length, length, 0, q.device)
    plain = ref.attention_ref(q, k, v, mask)
    assert smoke.k1_subset_agree(ref, plain, q, k, v, rows, mask)[2]
    got = k1_rounding_model(q, k, v, causal=True)
    err, rel, ok = smoke.k1_subset_agree(ref, got, q, k, v, rows, mask)
    print(f"causal L={length} rounding on {len(rows)} rows: max err {err:.5f}, rms {rel:.5f}")
    assert ok
    last = (length - 1) // smoke.K1_BM * smoke.K1_BM
    stale = got.clone()
    stale[:, last:] = got[:, last - smoke.K1_BM:last - smoke.K1_BM + length - last]
    err, rel, ok = smoke.k1_subset_agree(ref, stale, q, k, v, rows, mask)
    print(f"causal L={length} stale last tile: max err {err:.5f}, rms {rel:.5f}")
    assert not ok
    assert not smoke.k1_subset_agree(ref, ref.attention_ref(q, k, v), q, k, v, rows, mask)[2]


def test_top1_flip_counter_and_the_rate_bf16_gives_at_llama4s_width():
    """``topk_differ`` at top-1 splits the tokens whose expert differs from
    those kept on one side only; ``routes`` records each call of ``moe.route``.
    At llama4's width (5120 into 128 experts, its router's init), rounding
    the router's input to bf16 moves ~0.2% of 2200 tokens to another expert,
    and noise of 1% of its rms ~1.2%: MOE_FLIP_LIMIT sits between."""
    from repro_torch.models import common, moe
    idx = torch.tensor([[[0], [1], [2], [3]]])
    keep = torch.tensor([[[True], [True], [False], [True]]])
    expert, kept = smoke.topk_differ(
        [(torch.tensor([[[0], [2], [2], [3]]]), torch.tensor([[[True], [True], [True], [True]]]))],
        [(idx, keep)])
    assert expert.tolist() == [False, True, False, False]
    assert kept.tolist() == [False, False, True, False]
    cfg = dataclasses.replace(C.get_smoke(smoke.LLAMA4), capacity_factor=1.25)
    layer = moe.MoE(cfg, "cpu")
    layer.init_(torch.Generator().manual_seed(0))
    x = torch.randn((2, 6, cfg.d_model), generator=torch.Generator().manual_seed(1))
    out, seen = smoke.routes(moe, lambda: moe.moe_ffn(cfg, layer, x))
    assert moe.route is not None and len(seen) == 1 and seen[0][0].shape == (1, 12, 1)
    torch.testing.assert_close(out[0], moe.moe_ffn(cfg, layer, x)[0])
    g = torch.Generator().manual_seed(0)
    router = torch.empty((5120, 128))
    common.dense_init_(router, g)
    h = torch.randn((2200, 5120), generator=g)
    top = torch.softmax(h @ router, -1).argmax(-1)
    bf16 = (torch.softmax(h.bfloat16().float() @ router, -1).argmax(-1) != top).float().mean()
    noisy = h + 0.01 * torch.randn(h.shape, generator=g)
    far = (torch.softmax(noisy @ router, -1).argmax(-1) != top).float().mean()
    print(f"top-1 flips at 5120 x 128: bf16 input {bf16.item():.4f}, 1% noise {far.item():.4f}")
    assert bf16 < smoke.MOE_FLIP_LIMIT / 2 < smoke.MOE_FLIP_LIMIT < far


def test_llama4_phase_8c_memory_fits_the_card():
    """llama4's 4-layer cut: 35.0 B parameters, 65.3 GiB of bf16 weights;
    with the largest prefill transient (4 x 10240 tokens through an MoE
    layer) it stays under the card's 79 GiB."""
    cfg = smoke.llm_config(C, smoke.LLAMA4)
    weights = smoke.weights_gib(cfg)
    transient = smoke.prefill_transient_gib(cfg, max(smoke.LLAMA4_PROMPTS))
    print(f"llama4 cut: weights {weights:.2f} GiB, transient {transient:.2f} GiB")
    assert 65.0 < weights < 65.6
    assert 3 < transient and weights + transient < smoke.CARD_GIB
    # the MoE cut of phase 7: one layer, its experts and attention, 32.6 GB in
    # bf16 (65.2 GB in float32 on the CPU side)
    moe_cfg = smoke.moe_cut_config(C)
    assert moe_cfg.num_experts == 128 and moe_cfg.num_shared_experts == 1
    from repro_torch.models import transformer
    layer = transformer.AttentionLayer(moe_cfg, "attn_chunked", "meta", ffn="moe")
    assert abs(sum(p.numel() for p in layer.parameters()) * 2 / 1e9 - 32.6) < 0.1


def test_llm_bounds_count_the_weights_a_token_meets_and_the_masked_pairs():
    """Phase 8's bounds: a decode step reads every weight but the embedding
    tables once; a prefill group's products count each weight a token
    meets twice (llama4's 127 untaken experts a layer not at all) and four
    per kept query-key pair and head dim (llama4's chunks keep fewer)."""
    from repro_torch.models import transformer
    yi = C.get("yi-9b")
    model = transformer.Transformer(yi, "meta")
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    assert smoke.decode_bound_ms(model) == pytest.approx(
        (nbytes - yi.vocab_size * yi.d_model * 2) / smoke.PEAK_HBM * 1e3)
    l, b = 1810, smoke.LLM_BATCH
    layer = sum(p.numel() for p in model.layers[0].parameters()) + yi.d_model / yi.num_layers
    flops = (2.0 * b * (l * layer * yi.num_layers + yi.d_model * yi.vocab_size)
             + 4.0 * b * l * (l + 1) // 2 * yi.num_heads * yi.resolved_head_dim * yi.num_layers)
    assert smoke.prefill_bound_ms(yi, model, l) == pytest.approx(
        flops / smoke.PEAK_BF16_TENSOR * 1e3)
    cfg = smoke.llm_config(C, smoke.LLAMA4)
    llama = transformer.Transformer(cfg, "meta")
    l = 10240
    taken = (sum(p.numel() for p in llama.layers.parameters()) + cfg.d_model
             - 2 * 127 * 3 * cfg.d_model * cfg.moe_d_ff)
    pairs = 3 * (8192 * 8193 // 2 + 2048 * 2049 // 2) + l * (l + 1) // 2
    flops = (2.0 * b * (l * taken + cfg.d_model * cfg.vocab_size)
             + 4.0 * b * pairs * cfg.num_heads * cfg.resolved_head_dim)
    assert smoke.prefill_bound_ms(cfg, llama, l) == pytest.approx(
        flops / smoke.PEAK_BF16_TENSOR * 1e3)
    assert smoke.decode_bound_ms(llama) == pytest.approx(20.3, abs=0.05)


def _train_cut_models():
    """Phase 13 (b)'s deepseek cut (the dense layer, then an MoE one) at a
    reduced width, in bf16 (weights from a seed) and the same weights in
    float32, both learnable on the CPU."""
    from repro_torch.models import transformer
    cfg = dataclasses.replace(C.get("deepseek-moe-16b"), num_layers=2, d_model=256,
                              num_heads=4, num_kv_heads=4, head_dim=64, d_ff=512, moe_d_ff=128,
                              num_experts=16, experts_per_token=4, vocab_size=4096)
    bf = transformer.Transformer(cfg, "cpu")
    bf.init_(torch.Generator().manual_seed(14))
    f32 = transformer.Transformer(dataclasses.replace(cfg, dtype=torch.float32), "cpu")
    smoke.copy_params(torch, f32, bf)
    return cfg, bf.requires_grad_(True), f32.requires_grad_(True)


def _train_cut_sides(monkeypatch, backward=None, detach_router=False):
    """(b)'s readings of the bf16 side (``backward`` in place of
    ``train_cut_backward``; its router detached) against the float32 side."""
    from repro_torch.data import pipeline
    from repro_torch.models import moe
    from repro_torch.training import loop
    cfg, bf, f32 = _train_cut_models()
    batch = pipeline.to_tensors(pipeline.synthetic_batch(cfg, pipeline.DataConfig(1, 256), 0),
                                "cpu")
    want_nll, want_aux, want_r = smoke.train_cut_side(loop, moe, f32, batch)
    with monkeypatch.context() as m:
        if detach_router:           # in the forward and in remat's recompute alike
            real = moe.route
            m.setattr(moe, "route", lambda c, router, xg: real(c, router.detach(), xg))
        got_nll, got_aux, got_r = smoke.train_cut_side(loop, moe, bf, batch)
        expert, kept = smoke.topk_differ(got_r, want_r)
        keep = ~(expert | kept)
        got = (backward or smoke.train_cut_backward)(torch, bf, got_nll, got_aux, keep)
    want = smoke.train_cut_backward(torch, f32, want_nll, want_aux, keep)
    return smoke.train_cut_readings(got, want), int(expert.sum())


def _without_aux(torch, model, nll, aux, keep):
    """``train_cut_backward`` with the aux term left out of the loss (the
    aux reading itself kept)."""
    mean = nll.reshape(-1)[keep].mean()
    mean.backward()
    grads = {n: (torch.zeros(p.shape) if p.grad is None else p.grad.float())
             for n, p in model.named_parameters()}
    return {"loss": mean.item(), "nll": mean.item(), "aux": aux.item(), "grads": grads}


@pytest.mark.parametrize("fault", [None, "loss without aux", "detached router"])
def test_train_cut_limits_pass_bf16_and_reject_faults(fault, monkeypatch):
    """Phase 13 (b)'s limits pass bf16 against float32 on the same weights
    (tokens whose experts differ left out) and reject a loss without its
    aux term and a router that takes no gradient."""
    readings, flips = _train_cut_sides(
        monkeypatch, backward=_without_aux if fault == "loss without aux" else None,
        detach_router=fault == "detached router")
    print(f"{fault or 'bf16 rounding'}: {readings}, {flips} of 256 tokens changed experts")
    if fault is None:
        smoke.check_train_readings("bf16 cut", readings)
        assert all(readings[k] < smoke.TRAIN_CUT_TOL[k] / 2 for k in smoke.TRAIN_CUT_TOL)
        assert flips < smoke.TRAIN_FLIP_LIMIT * 256
        return
    with pytest.raises(RuntimeError, match="card vs CPU"):
        smoke.check_train_readings(fault, readings)
    if fault == "detached router":
        assert readings["worst_grad"].endswith("moe.router") and readings["grad"] == 1.0


def test_topk_flip_counter_compares_sets_of_experts():
    """A token whose k experts come in another order is the same; one with
    another expert differs; one kept by an expert on one side only counts
    apart, over every recorded MoE call."""
    want = [(torch.tensor([[[0, 1], [2, 3], [1, 2]]]),
             torch.tensor([[[True, True], [True, True], [True, True]]]))] * 2
    got = [(torch.tensor([[[1, 0], [2, 3], [1, 2]]]),
            torch.tensor([[[True, True], [True, True], [True, False]]])),
           (torch.tensor([[[0, 1], [2, 0], [1, 2]]]),
            torch.tensor([[[True, True], [True, True], [True, True]]]))]
    expert, kept = smoke.topk_differ(got, want)
    assert expert.tolist() == [False, True, False] and kept.tolist() == [False, False, True]


def test_restore_check_rejects_a_restore_that_drops_the_moments(tmp_path):
    """Phase 13 (a)'s check passes a restore of every tensor and rejects one
    that restores the parameters and leaves the moments as they were."""
    from repro_torch.data import pipeline
    from repro_torch.training import checkpoint, loop
    cfg = C.get_smoke("yi-9b")
    state = loop.init_state(cfg, 0, "cpu")
    batch = pipeline.to_tensors(pipeline.synthetic_batch(cfg, pipeline.DataConfig(2, 16), 0),
                                "cpu")
    state, _ = loop.make_train_step(cfg)(state, batch)
    saved = {k: t.clone() for k, t in checkpoint.state_tree(state).items()}
    path = str(tmp_path / "s.pt")
    checkpoint.save_state(path, state)
    back = checkpoint.restore_state(path, loop.init_state(cfg, 1, "cpu"))
    smoke.check_restore(torch, saved, checkpoint.state_tree(back))

    def params_only(p, st):
        tree = checkpoint.restore(p, checkpoint.state_tree(st))
        for k, t in checkpoint.state_tree(st).items():
            if k.startswith("params."):
                t.copy_(tree[k])
        return st
    with torch.no_grad():
        dropped = params_only(path, loop.init_state(cfg, 1, "cpu"))
    with pytest.raises(RuntimeError, match="differs"):
        smoke.check_restore(torch, saved, checkpoint.state_tree(dropped))


def test_train_memory_and_bound_are_reckoned_from_the_shapes():
    """The reckoning of (c): weights and grads in their dtypes, 8 bytes of
    moments a parameter, the remat inputs and three f32 score tensors; the
    bound's products 6 per token and weight met, 12 per kept pair and head
    dim, for yi-9b cut to 8 layers at 4 x 2048 tokens."""
    from repro_torch.models import transformer
    cfg = dataclasses.replace(C.get("yi-9b"), num_layers=8)
    model = transformer.Transformer(cfg, "meta")
    n = sum(p.numel() for p in model.parameters())
    mem = smoke.train_memory_gib(cfg, 4, 2048)
    assert mem["params"] == n and mem["moments"] == pytest.approx(8 * n / 2 ** 30)
    assert mem["transient"] == pytest.approx(3 * 4 * 32 * 2048 ** 2 * 4 / 2 ** 30)
    per_token = n - cfg.vocab_size * cfg.d_model
    flops = (6.0 * 4 * 2048 * per_token
             + 12.0 * 4 * (2048 * 2049 // 2) * 32 * 128 * 8)
    ms, by = smoke.train_bound_ms(cfg, 4, 2048)
    assert by == "operations" and ms == pytest.approx(flops / smoke.PEAK_BF16_TENSOR * 1e3)


def test_sharding_phase_checks_pass_the_sharded_paths_and_reject_their_faults():
    """Phase 14's comparison helpers on a world of 4 CPU ranks: the
    gathered Ulysses output and the chunk-parallel scan pass (each against
    its unsharded plain version, at K1's and K3's limits); a Ulysses whose
    all-to-alls swap the sequence and head axes, and a ladder that does not
    decay the prefix, are rejected. (c)'s train check passes one sharded
    step of deepseek-moe (fsdp, 2x2) and rejects the same step with one
    parameter's update dropped, which its loss and gradient norm do not
    show, and a row off any other limit or with a kernel launched."""
    import test_torch_sharding_faults as faults

    from repro_torch.kernels import ops
    from repro_torch.launch import shard_check as sc
    attn = [sc.AttnCase("causal", 1, 512, 8, 32, causal=True, dtype="bfloat16", seed=1),
            sc.AttnCase("bidir", 1, 256, 4, 64, dtype="bfloat16", seed=2)]
    scan = [sc.ScanCase("rwkv6", 1, 4, 64, 16, 16, True, seed=3),
            sc.ScanCase("zamba2", 1, 4, 64, 16, 16, False, layout="zamba2", floor=True, seed=4)]
    train = [sc.TrainCase("deepseek-moe-16b", (2, 2), ("fsdp",), steps=1)]
    res = sc.run(4, faults.faulty_suite, attn, scan, train, None, train,
                 "layers.1.moe.w_up", device="cpu")[0]
    for case, got in zip(attn, res["ulysses"]["outputs"]):
        row = smoke.sharded_attention_row(ops, ref, sc, case, got, 4, 0.0, ops.flash_attention,
                                          device="cpu")
        print(row)
    for case, got in zip(scan, res["scan"]["outputs"]):
        row = smoke.sharded_scan_row(torch, sc, case, got, 4, 0.0, ops.linear_scan, device="cpu")
        print(row)
        assert row["finite"]
    with pytest.raises(RuntimeError, match="K1's limits"):
        smoke.sharded_attention_row(ops, ref, sc, attn[0],
                                    res["faults"]["a2a_swapped"]["outputs"][0], 4, 0.0,
                                    ops.flash_attention, device="cpu")
    with pytest.raises(RuntimeError, match="K3's limits"):
        smoke.sharded_scan_row(torch, sc, scan[0], res["faults"]["ladder_no_decay"]["outputs"][0],
                               4, 0.0, ops.linear_scan, device="cpu")
    good = res["train"][0]
    print(smoke.sharded_train_row(good))
    dropped = res["faults"]["dropped_update"][0]
    assert dropped["loss"] <= smoke.SP_LOSS_TOL and dropped["grad_norm"] <= smoke.SP_GNORM_TOL
    with pytest.raises(RuntimeError, match="off its limits"):
        smoke.sharded_train_row(dropped)
    for bad in ({"loss": 2e-5}, {"aux": 2e-5}, {"grad_norm": 2e-4}, {"params": 2e-4},
                {"updates": 2e-3}, {"moments": 2e-4}, {"moments_of_max": 2e-4},
                {"launches": dict(good["launches"], flash_attention=1)}):
        with pytest.raises(RuntimeError):
            smoke.sharded_train_row(dict(good, **bad))
