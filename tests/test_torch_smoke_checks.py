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
    for groups in (1, 2):
        assert smoke.expected_launches(C.get(arch), groups) == {
            "flash_attention": k1 * groups, "adaln_rmsnorm": 0, "ssm_scan": k3 * groups}


def test_phase_8_launches_add_up_to_the_prediction():
    served = smoke.LLM_ARCHS + smoke.ATTN_ARCHS
    k1 = sum(smoke.expected_launches(C.get(a), 2)["flash_attention"] for a in served)
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
