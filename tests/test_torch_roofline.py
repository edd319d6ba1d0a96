"""The port's roofline (``repro_torch.roofline``) against the reference's
(``repro.roofline``), on the CPU.

The counter's known answers: the reference's ``tests/test_roofline.py``
cases with the same numbers (an eager loop counts every iteration, where
the reference multiplies its ``while`` bodies), the collectives on a fake
world of 4, and a DTensor product on a fake 16x16 world on its first and
its second call. A step counted on ``meta`` equals the same step on the
CPU (FLOPs, bytes, kernel calls). ``model_flops``, the skip reasons and the
three terms under ``REFERENCE_HW`` equal the reference's; whole smoke steps
are held against the reference's ``hlo.module_costs``, their differences
accounted for. The bounds ``chip_smoke.py`` prints keep the values recorded
before they moved into ``roofline.analysis`` and the kernel modules.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

import repro.configs as JC
from repro.kernels import ops as jops
from repro.launch import specs as jspecs
from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.roofline import analysis as jra
from repro.roofline import hlo
from repro.training import loop as jloop
import repro_torch.configs as TC
from repro_torch.core.profiler import H100_SXM, REFERENCE_HW
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import adaln_rmsnorm as ar
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssm_scan as ss
from repro_torch.launch import specs as tspecs
from repro_torch.models import diffusion as tdiff
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.roofline import analysis as tra
from repro_torch.roofline import counts
from repro_torch.training import loop as tloop

META = torch.device("meta")


def _ref_flops(fn, *args) -> float:
    return hlo.module_costs(jax.jit(fn).lower(*args).compile().as_text(), 1).flops


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


# ---------------------------------------------------------------------------
# The counter's known answers
# ---------------------------------------------------------------------------

def test_loop_of_products_counts_every_iteration():
    """Eight 128x128 products: the reference multiplies its scan's body by
    its trip count; an eager loop runs it eight times."""
    def loop(x):
        for _ in range(8):
            x = x @ x
        return x

    want = 8 * 2 * 128 ** 3
    assert counts.module_costs(loop, _meta(128, 128)).flops == want
    scanned = _ref_flops(lambda x: jax.lax.scan(lambda c, _: (c @ c, None), x, None, length=8)[0],
                         jax.ShapeDtypeStruct((128, 128), jnp.float32))
    assert scanned == want


def test_nested_loops_count_every_iteration():
    def loop(x):
        for _ in range(4):
            for _ in range(3):
                x = x @ x
        return x

    def inner(c, _):
        return c @ c, None

    def outer(c, _):
        return jax.lax.scan(inner, c, None, length=3)[0], None

    want = 12 * 2 * 64 ** 3
    assert counts.module_costs(loop, _meta(64, 64)).flops == want
    assert _ref_flops(lambda x: jax.lax.scan(outer, x, None, length=4)[0],
                      jax.ShapeDtypeStruct((64, 64), jnp.float32)) == want


def test_batched_einsum_counts_its_product():
    want = 2 * 4 * 32 * 64 * 16
    got = counts.module_costs(lambda a, b: torch.einsum("bij,bjk->bik", a, b),
                              _meta(4, 32, 64), _meta(4, 64, 16))
    assert got.flops == want
    assert _ref_flops(lambda a, b: jnp.einsum("bij,bjk->bik", a, b),
                      jax.ShapeDtypeStruct((4, 32, 64), jnp.float32),
                      jax.ShapeDtypeStruct((4, 64, 16), jnp.float32)) == want
    # the product reads both operands and writes its result once
    assert got.hbm_bytes == 4 * (4 * 32 * 64 + 4 * 64 * 16 + 4 * 32 * 16)


def test_collectives_on_a_fake_world_of_four():
    """The reference's HLO case: an all-reduce of a (16, 16) f32 over 4
    ranks, then an all-gather into (16, 16) over 2: 2 * 3/4 * 1024 + 1/2 *
    1024 wire bytes."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from repro_torch.launch import mesh as mesh_lib

    def step():
        pair = mesh_lib.build(mesh_lib.MeshShape(("data", "model"), (2, 2)), "cpu")
        y = funcol.all_reduce(_meta(16, 16), "sum", dist.group.WORLD)
        z = funcol.all_gather_tensor(_meta(8, 16), 0, (pair, 1))
        return y, z

    mc = counts.module_costs(step, world=4)
    assert not dist.is_initialized()
    assert mc.collective_counts == {"all-reduce": 1, "all-gather": 1}
    assert mc.collective_wire_bytes == 2 * 0.75 * 1024 + 0.5 * 1024 == 2048
    assert mc.wire_by_group == {(0, 1, 2, 3): 1536.0, (0, 1): 512.0}
    # a link domain of 2 ranks holds the pair, not the world
    assert mc.wide_wire_bytes(2) == 1536.0 and mc.wide_wire_bytes(4) == mc.wide_wire_bytes(0) == 0
    text = """
HloModule m

ENTRY %main (p: f32[16,16]) -> f32[16,16] {
  %p = f32[16,16]{1,0} parameter(0)
  %ar = f32[16,16]{1,0} all-reduce(%p), replica_groups={{0,1,2,3}}, to_apply=%add
  ROOT %ag = f32[16,16]{1,0} all-gather(%ar), replica_groups={{0,1}}, dimensions={0}
}
"""
    want = hlo.module_costs(text, 4)
    assert mc.collective_counts == want.collective_counts
    assert mc.collective_wire_bytes == want.collective_wire_bytes


def test_dtensor_product_counts_the_local_product_on_both_calls():
    """Shard(0) x Shard(1) operands of a (4096, 4096) bf16 product on a fake
    16x16 world: 2 * 256 * 256 * 4096 FLOPs a device, first call and second;
    DTensor's propagation on the global shapes, which runs on the first call
    only, is not counted."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch import mesh as mesh_lib

    def twice():
        mesh = mesh_lib.build(mesh_lib.make_production_mesh(), "cpu")
        a = _meta(4096, 4096, dtype=torch.bfloat16)
        x = DTensor.from_local(a[:256], mesh, [Shard(0), Replicate()], run_check=False,
                               shape=a.shape, stride=a.stride())
        w = DTensor.from_local(a[:, :256], mesh, [Replicate(), Shard(1)], run_check=False,
                               shape=a.shape, stride=a.stride())
        return [counts.count(lambda: x @ w)[1] for _ in range(2)]

    with counts.fake_world(256):
        first, second = twice()
    for mc in (first, second):
        assert mc.flops == 2 * 256 * 256 * 4096 == 536_870_912
        assert mc.hbm_bytes == 2 * (256 * 4096 * 2 + 256 * 256)
        assert mc.collective_counts == {}


def test_convolution_counts_exactly():
    """The port counts torch's exact formula, 2 * N * Ho * Wo * Cout * Cin * kh
    * kw. The reference's ``_conv_flops`` divides the kernel's elements by
    its last dimension, which is exact when XLA lays the kernel out
    ``...io`` (it does on the CPU, even for an OIHW kernel): on the
    decoder's 3x3 convolution both count the same."""
    n, h, w, ci, co = 2, 16, 16, 8, 32
    got = counts.module_costs(lambda a, b: F.conv2d(a, b, padding=1), _meta(n, ci, h, w),
                              _meta(co, ci, 3, 3)).flops
    assert got == 2 * n * h * w * co * ci * 9
    want = _ref_flops(lambda a, b: jax.lax.conv_general_dilated(
        a, b, (1, 1), "SAME", dimension_numbers=("NHWC", "OIHW", "NHWC")),
        jax.ShapeDtypeStruct((n, h, w, ci), jnp.float32),
        jax.ShapeDtypeStruct((co, ci, 3, 3), jnp.float32))
    assert got == want


def test_peak_counts_the_arguments_and_the_most_live_storages():
    """(x + 1) * 2 on a 1024-float x: x, then x + 1 and its product live at
    once; each storage is freed with its last tensor."""
    x = _meta(1024)
    assert counts.count(lambda t: (t + 1) * 2, x)[1].peak_bytes == 3 * 4096

    def chain(t):
        for _ in range(5):
            t = t + 1          # each step's input dies with the step
        return t

    assert counts.count(chain, x)[1].peak_bytes == 3 * 4096
    # a view of an argument holds no new storage
    assert counts.count(lambda t: t.view(32, 32).t() * 2, x)[1].peak_bytes == 2 * 4096


def test_views_allocations_and_overwrites_move_no_extra_bytes():
    x = _meta(64, 64)

    def step(t):
        u = (t.t()[:10], t.view(-1), t.expand(3, 64, 64))     # views
        e = torch.empty_like(t)            # an allocation
        e.copy_(t)                         # writes e, reads t
        return u, e

    mc = counts.module_costs(step, x)
    assert mc.hbm_bytes == 2 * 64 * 64 * 4 and mc.flops == 0


# ---------------------------------------------------------------------------
# The kernel ops under the counter
# ---------------------------------------------------------------------------

K1_SHAPES = [(1, 128, 128, 4, 64, True, 0), (2, 17, 300, 2, 128, True, 0),
             (1, 256, 256, 2, 64, False, 0), (1, 300, 300, 2, 256, True, 130),
             (2, 5, 3, 1, 64, True, 2)]


@pytest.mark.parametrize("b,lq,lkv,h,d,causal,window", K1_SHAPES)
def test_k1_cost_is_the_smoke_formula(b, lq, lkv, h, d, causal, window):
    """K1's cost as chip_smoke.py reckoned it before it moved: 4 per pair of
    the mask and head dim; q, k, v and o once, two bytes an element."""
    q, k, v = _meta(b, lq, h, d, dtype=torch.bfloat16), _meta(b, lkv, h, d, dtype=torch.bfloat16), \
        _meta(b, lkv, h, d, dtype=torch.bfloat16)
    mask = ops.attention_mask(lq, lkv, window, "cpu") if causal or window else None
    pairs = int(mask.sum().item()) * b * h if mask is not None else b * h * lq * lkv
    flops, nbytes = 4.0 * pairs * d, 2 * (2 * b * lq * h * d + 2 * b * lkv * h * d)
    assert fa.cost(q, k, v, causal=causal, window=window) == (flops, nbytes)
    ms, by = tra.kernel_bound_ms(fa, (flops, nbytes))
    assert ms == max(flops / 989e12, nbytes / 3.35e12) * 1e3
    assert by == ("operations" if flops / 989e12 > nbytes / 3.35e12 else "bytes")


@pytest.mark.parametrize("b,l,d,dt", [(1, 1101, 1536, torch.bfloat16),
                                      (2, 4173, 3072, torch.float32), (4, 7, 64, torch.bfloat16)])
def test_k2_cost_is_the_smoke_formula(b, l, d, dt):
    x, mod = _meta(b, l, d, dtype=dt), _meta(b, 6, d, dtype=dt)
    es = x.element_size()
    want = (6.0 * b * l * d, 2 * b * l * d * es + 2 * b * d * es)
    assert ar.cost(x, mod[:, 0], mod[:, 1]) == want
    ms, by = tra.kernel_bound_ms(ar, want)
    assert ms == max(want[1] / 3.35e12, want[0] / 67e12) * 1e3
    assert by == ("bytes" if want[1] / 3.35e12 >= want[0] / 67e12 else "operations")


@pytest.mark.parametrize("shared", [False, True])
def test_k3_cost_is_the_smoke_formula(shared):
    """K3's cost: the unique bytes of its inputs (zamba2's head-shared q/k
    and per-head decay as stride-0 views, once), both outputs, the bonus
    and the initial state; 5 per token, K and V element."""
    b, h, l, dk, dv = 2, 8, 300, 64, 64
    if shared:
        q = _meta(b, 1, l, dk).expand(b, h, l, dk)
        decay = _meta(b, h, l, 1).expand(b, h, l, dk)
        bonus = None
    else:
        q = _meta(b, h, l, dk)
        decay = _meta(b, h, l, dk)
        bonus = _meta(h, dk)
    k, v, s0 = q, _meta(b, h, l, dv, dtype=torch.float32), _meta(b, h, dk, dv)
    out, final = _meta(b, h, l, dv), _meta(b, h, dk, dv)

    def unique(t):
        n = 1
        for size, stride in zip(t.shape, t.stride()):
            n *= size if stride else 1
        return n * t.element_size()

    nbytes = sum(unique(t) for t in (q, k, v, decay, out, final)
                 + tuple(t for t in (bonus, s0) if t is not None))
    want = (5.0 * b * h * l * dk * dv, nbytes)
    assert ss.cost(q, k, v, decay, bonus=bonus, initial_state=s0) == want
    assert tra.kernel_bound_ms(ss, want)[0] == max(nbytes / 3.35e12, want[0] / 67e12) * 1e3


def test_kernel_ops_on_meta_build_and_launch_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a meta call reached the kernel build")

    monkeypatch.setattr(_build, "function", refuse)
    monkeypatch.setattr(_build, "library", refuse)
    before = dict(ops.LAUNCHES)
    q = _meta(2, 40, 4, 64, dtype=torch.bfloat16)
    o = ops.flash_attention(q, q, q, causal=True)
    assert o.shape == q.shape and o.dtype == q.dtype and o.is_contiguous() and o.is_meta
    x = _meta(2, 40, 96, dtype=torch.bfloat16)
    y = ops.adaln_rmsnorm(x, _meta(2, 96, dtype=torch.bfloat16), _meta(2, 96, dtype=torch.bfloat16))
    assert y.shape == x.shape and y.dtype == x.dtype
    s = _meta(2, 4, 40, 16, dtype=torch.bfloat16)
    out, final = ops.linear_scan(s, s, _meta(2, 4, 40, 32, dtype=torch.bfloat16),
                                 _meta(2, 4, 40, 16), bonus=_meta(4, 16))
    assert (out.shape, out.dtype) == ((2, 4, 40, 32), torch.bfloat16)
    assert (final.shape, final.dtype) == ((2, 4, 16, 32), torch.float32)
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_kernel_ops_record_their_cost_once_a_call(device):
    """Under the counter each op adds its kernel's cost and one call; on the
    CPU the plain version's own ops (the mask, the L x L scores) are not
    counted."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 24, 2, 64), generator=g).to(device)
    x = torch.randn((1, 24, 32), generator=g).to(device)
    m = torch.randn((1, 32), generator=g).to(device)
    s = torch.rand((1, 2, 24, 16), generator=g).to(device)

    def step():
        ops.flash_attention(q, q, q, causal=True, window=5)
        ops.adaln_rmsnorm(x, m, m)
        ops.linear_scan(s, s, s, s)

    _, mc = counts.count(step)
    parts = (fa.cost(q, q, q, causal=True, window=5), ar.cost(x, m, m), ss.cost(s, s, s, s))
    assert mc.kernel_calls == {"flash_attention": 1, "adaln_rmsnorm": 1, "ssm_scan": 1}
    assert mc.flops == sum(c[0] for c in parts)
    assert mc.hbm_bytes == sum(c[1] for c in parts)
    assert ops.COUNTER is None


SMOKE_ARCHS = ["yi-9b", "rwkv6-3b", "deepseek-moe-16b", "zamba2-1.2b", "musicgen-medium",
               "internvl2-2b"]


def _smoke_step(cfg, kind: str, device: str, b: int = 2, l: int = 48):
    """(fn, args) of a smoke step on ``device``: the model built from a
    seed on the CPU, allocated on ``meta``."""
    dev = torch.device(device)
    shape = (b, cfg.num_codebooks, l) if cfg.modality == "audio_codec" else (b, l)
    tokens = torch.zeros(shape, dtype=torch.int64, device=dev)
    pe = (torch.zeros((b, cfg.vision_tokens, cfg.vision_embed_dim), device=dev)
          if cfg.modality == "vision" else None)
    if kind == "train":
        state = tloop.init_state(cfg, 0, dev) if device == "cpu" else tspecs.meta_state(cfg)
        batch = {"tokens": tokens, "labels": tokens}
        if pe is not None:
            batch["patch_embeds"] = pe
        return tloop.make_train_step(cfg), (state, batch)
    model = ttf.build(cfg, dev, 0) if device == "cpu" else ttf.Transformer(cfg, dev)
    if kind == "prefill":
        return (lambda m, t: m.prefill(t, l + 8, prefix_embeds=pe)), (model, tokens)
    caches = model.init_cache(b, l + 8)
    return (lambda m, t, c: m.decode_step(t, c, l)), (model, tokens[..., :1], caches)


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_a_step_on_meta_counts_what_it_counts_on_the_cpu(arch, kind):
    cfg = TC.get_smoke(arch)
    got = {}
    for device in ("cpu", "meta"):
        fn, args = _smoke_step(cfg, kind, device)
        with torch.no_grad() if kind != "train" else torch.enable_grad():
            got[device] = counts.count(fn, *args)[1]
    cpu, meta = got["cpu"], got["meta"]
    assert cpu.flops > 0 and cpu.hbm_bytes > 0
    assert (cpu.flops, cpu.hbm_bytes, cpu.kernel_calls) == (meta.flops, meta.hbm_bytes,
                                                            meta.kernel_calls)
    assert bool(cpu.kernel_calls) == (kind == "prefill")


def test_a_dit_step_on_meta_counts_what_it_counts_on_the_cpu():
    cfg = TC.get_smoke("sd3").dit
    got = {}
    for device in ("cpu", "meta"):
        dit = tdiff.DiT(cfg, device)
        if device == "cpu":
            dit.init_(torch.Generator().manual_seed(0))
        x = torch.zeros((1, 64, cfg.latent_dim), device=device)
        c = torch.zeros((1, 7, cfg.cond_dim), device=device)
        t = torch.full((1,), 500.0, device=device)
        with torch.no_grad():
            got[device] = counts.count(lambda m, *a: m(*a), dit, x, t, c)[1]
    assert got["cpu"].kernel_calls == {"adaln_rmsnorm": 2 * cfg.num_layers + 1,
                                       "flash_attention": cfg.num_layers}
    assert (got["cpu"].flops, got["cpu"].hbm_bytes) == (got["meta"].flops, got["meta"].hbm_bytes)


# ---------------------------------------------------------------------------
# The analysis against the reference's
# ---------------------------------------------------------------------------

def test_input_shapes_and_long_context_rules_equal_the_references():
    assert {k: dataclasses.astuple(v) for k, v in TC.INPUT_SHAPES.items()} == \
           {k: dataclasses.astuple(v) for k, v in JC.INPUT_SHAPES.items()}
    for arch in TC.ARCH_IDS:
        t, j = TC.get(arch), JC.get(arch)
        assert t.is_subquadratic() == j.is_subquadratic(), arch
        assert t.supports_long_context() == j.supports_long_context(), arch


def test_long500k_skip_set_and_reasons_equal_the_references():
    skipped = {}
    for arch in TC.ARCH_IDS:
        got = tspecs.input_specs(arch, "long_500k").skipped
        want = jspecs.input_specs(arch, "long_500k").skipped
        assert got == want, arch
        if got:
            skipped[arch] = got
    assert set(skipped) == {"yi-34b", "yi-9b", "internvl2-2b", "deepseek-moe-16b",
                            "musicgen-medium"}


@pytest.mark.parametrize("arch", list(TC.ARCH_IDS))
def test_model_flops_equal_the_references(arch):
    t, j = TC.get(arch), JC.get(arch)
    for kind, batch, seq in (("train", 256, 4096), ("prefill", 32, 32768), ("decode", 128, 32768)):
        assert tra.model_flops(t, kind, batch, seq) == pytest.approx(
            jra.model_flops(j, kind, batch, seq), rel=1e-12), (arch, kind)


def test_roofline_terms_under_the_reference_constants_equal_the_references():
    kw = dict(arch="yi-9b", shape="train_4k", mesh="16x16", chips=256, hlo_flops=3.1e15,
              hlo_bytes=7.7e12, coll_bytes=2.2e11, model_flops=5.5e17,
              coll_counts={"all-gather": 3}, peak_mem_bytes=1e10)
    got, want = tra.Roofline(**kw, hw=REFERENCE_HW), jra.Roofline(**kw)
    for term in ("t_compute", "t_memory", "t_collective", "bottleneck", "useful_ratio"):
        assert getattr(got, term) == getattr(want, term), term
    assert got.row() == want.row()
    assert REFERENCE_HW.link_domain_chips == 0


def test_roofline_prices_wide_groups_at_the_nic():
    mc = counts.ModuleCosts(flops=989e12, hbm_bytes=3.35e12, collective_wire_bytes=900e9 + 50e9,
                            collective_counts={"all-reduce": 2}, kernel_calls={}, peak_bytes=0,
                            wire_by_group={tuple(range(8)): 900e9, tuple(range(0, 256, 16)): 50e9})
    roof = tra.Roofline.from_costs("x", "s", "16x16", 256, mc, 0.0, H100_SXM)
    assert roof.coll_bytes_wide == 50e9
    assert roof.t_compute == pytest.approx(1.0) and roof.t_memory == pytest.approx(1.0)
    assert roof.t_collective == pytest.approx(1.0 + 1.0)
    assert roof.bottleneck == "collective" and roof.t_bound == roof.t_collective
    flat = tra.Roofline.from_costs("x", "s", "16x16", 256, mc, 0.0, REFERENCE_HW)
    assert flat.t_collective == pytest.approx(950e9 / 50e9)


# ---------------------------------------------------------------------------
# Whole smoke steps against the reference's hlo.module_costs
# ---------------------------------------------------------------------------

B, L = 2, 256


def _ref_step_flops(arch: str, kind: str) -> float:
    cfg = JC.get_smoke(arch)
    key = jax.random.PRNGKey(0)
    tok = jax.ShapeDtypeStruct((B, L), jnp.int32)
    if kind == "train":
        state = jax.eval_shape(lambda k: jloop.init_state(cfg, k), key)
        return _ref_flops(jloop.make_train_step(cfg), state, {"tokens": tok, "labels": tok})
    params = jax.eval_shape(lambda k: jtf.init(cfg, k), key)
    if kind == "prefill":
        return _ref_flops(lambda p, t: jtf.prefill(cfg, p, t, L + 8), params, tok)
    cache = jax.eval_shape(lambda: jtf.init_cache(cfg, B, L + 8))
    return _ref_flops(lambda p, t, c: jtf.decode_step(cfg, p, t, c, L), params,
                      jax.ShapeDtypeStruct((B, 1), jnp.int32), cache)


def _port_step(arch: str, kind: str):
    cfg = TC.get_smoke(arch)
    tokens = torch.empty((B, L), dtype=torch.int64, device=META)
    if kind == "train":
        return counts.count(tloop.make_train_step(cfg), tspecs.meta_state(cfg),
                            {"tokens": tokens, "labels": tokens})[1]
    model = ttf.Transformer(cfg, META)
    with torch.no_grad():
        if kind == "prefill":
            return counts.count(lambda: model.prefill(tokens, L + 8))[1]
        return counts.count(lambda: model.decode_step(tokens[:, :1], model.init_cache(B, L + 8),
                                                      L))[1]


def _ref_attention_flops(cfg) -> float:
    """The reference's smoke prefill attention (its smoke configs run the
    plain attention, ``use_flash`` off): every layer's whole L x L square."""
    dh = cfg.head_dim or cfg.d_model // cfg.num_heads
    s = jax.ShapeDtypeStruct((B, L, cfg.num_heads, dh), jnp.float32)
    mask = jnp.ones((L, L), bool)
    one = _ref_flops(lambda q, k, v: jcommon.attention(q, k, v, mask), s, s, s)
    return one * sum(1 for m, _ in cfg.layer_kinds() if m.startswith("attn"))


def _ref_scan_flops(cfg) -> float:
    """The reference's smoke prefill scan (the chunked reference, chunk 32)
    at rwkv6's shapes, every layer."""
    h = cfg.resolved_ssm_heads if hasattr(cfg, "resolved_ssm_heads") else cfg.num_heads
    dk = cfg.head_dim or cfg.d_model // cfg.num_heads
    s = jax.ShapeDtypeStruct((B, h, L, dk), jnp.float32)
    st = jax.ShapeDtypeStruct((B, h, dk, dk), jnp.float32)
    one = _ref_flops(lambda q, k, v, w, u, s0: jops.linear_scan(q, k, v, w, bonus=u,
                                                                initial_state=s0),
                     s, s, s, s, jax.ShapeDtypeStruct((h, dk), jnp.float32), st)
    return one * cfg.num_layers


def _moe_flops_gap(arch: str) -> float:
    """What the reference's MoE layer counts beyond the port's at the smoke
    prefill's tokens, every MoE layer: its one-hot (G, S, E, C) dispatch and
    combine einsums, where the port gathers."""
    jcfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
    p = jax.eval_shape(lambda k: jmoe.init_moe(jcfg, k), jax.random.PRNGKey(0))
    x = jax.ShapeDtypeStruct((B, L, jcfg.d_model), jnp.float32)
    ref_one = _ref_flops(lambda pp, xx: jmoe.moe_ffn(jcfg, pp, xx), p, x)
    layer = tmoe.MoE(tcfg, META)
    port_one = counts.module_costs(lambda xx: tmoe.moe_ffn(tcfg, layer, xx),
                                   _meta(B, L, tcfg.d_model, dtype=tcfg.dtype)).flops
    return (ref_one - port_one) * sum(1 for _, f in tcfg.layer_kinds() if f == "moe")


WHOLE_STEPS = [(a, k) for a in ("yi-9b", "rwkv6-3b", "deepseek-moe-16b")
               for k in ("prefill", "decode", "train")]


@pytest.mark.parametrize("arch,kind", WHOLE_STEPS)
def test_whole_smoke_steps_against_the_reference(arch, kind):
    """The port's FLOPs of a smoke step against ``hlo.module_costs`` of the
    reference's on the same config and shape (B = 2, L = 256).

    The products outside attention, the scan and the MoE's dispatch agree
    exactly: the port's count less its kernels' equals the reference's less
    its own count of the same regions. Those regions differ by design:
    the reference's smoke prefill runs the plain attention over the whole
    L x L square (``use_flash`` off) where the port counts K1 by kept
    pairs, and its chunked scan (chunk 32) where the port counts K3's 5 per
    token, K and V element; its MoE dispatches and combines through one-hot
    (G, S, E, C) einsums where the port gathers. Training runs the same
    plain math in both but for the scan's chunk (16 in the port, 32 in the
    reference); the whole step agrees within the stated bound."""
    cfg = JC.get_smoke(arch)
    want = _ref_step_flops(arch, kind)
    mc = _port_step(arch, kind)
    kernels = sum(mc.by_op.get(k, [0, 0.0])[1] for k in ("flash_attention", "ssm_scan"))
    assert bool(kernels) == (kind == "prefill")
    regions = 0.0
    if kind == "prefill":
        regions = (_ref_scan_flops(cfg) if arch == "rwkv6-3b" else _ref_attention_flops(cfg))
    if cfg.num_experts and kind == "prefill":
        regions += _moe_flops_gap(arch)
    if kind == "train" and arch != "yi-9b":
        # the scan's chunk and the MoE's einsums (forward and backward)
        assert mc.flops == pytest.approx(want, rel={"rwkv6-3b": 0.02,
                                                    "deepseek-moe-16b": 0.33}[arch])
        return
    if kind == "decode" and cfg.num_experts:
        regions = 0.0
        assert mc.flops == pytest.approx(want, rel=0.01)   # the one-hot einsums at 2 tokens
        return
    assert mc.flops - kernels == want - regions
    # the whole step: the reference's attention square against the kept pairs
    assert mc.flops == pytest.approx(want, rel=0.5)


# ---------------------------------------------------------------------------
# The bounds chip_smoke.py prints, recorded before they moved
# ---------------------------------------------------------------------------

DECODE_BOUNDS = {"zamba2-1.2b": 0.77, "rwkv6-3b": 1.73, "yi-9b": 5.12, "yi-34b": 20.26,
                 "starcoder2-15b": 12.95, "gemma2-9b": 4.97, "deepseek-moe-16b": 9.65,
                 "llama4-maverick-400b-a17b": 20.30, "internvl2-2b": 1.02,
                 "musicgen-medium": 1.09}
PREFILL_BOUNDS = {"zamba2-1.2b": [(1810, 18.209624225520727), (854, 8.510852850798786)],
                  "rwkv6-3b": [(1810, 40.08637302293226), (854, 18.914397764853387)],
                  "yi-9b": [(1810, 126.81084961132457), (854, 58.535015017092014)],
                  "yi-34b": [(1810, 501.46394551005056), (854, 233.764021673545)],
                  "starcoder2-15b": [(5877, 1079.2933800012618), (5975, 1097.846762977456)],
                  "gemma2-9b": [(5877, 441.58007796300103), (5975, 449.54540036141555)],
                  "deepseek-moe-16b": [(1810, 36.79568501516683), (854, 16.983252138839234)],
                  "llama4-maverick-400b-a17b": [(10240, 96.70501437087968),
                                                (9216, 87.13957542490597)],
                  "internvl2-2b": [(2066, 26.97015099690192), (1110, 14.069058801245703)],
                  "musicgen-medium": [(1314, 20.291138393302326), (986, 15.033224905383216)]}
TRAIN_BOUNDS = {("yi-9b", 8): (85.15748423131244, "operations"),
                ("deepseek-moe-16b", 4): (28.27254370051365, "operations"),
                ("rwkv6-3b", None): (144.4056457655005, "operations")}
TRAIN_GIB = {"yi-9b": 27.82916259765625, "deepseek-moe-16b": 34.837677001953125,
             "rwkv6-3b": 41.599708557128906}


def _llm_config(arch):
    cfg = TC.get(arch)
    return dataclasses.replace(cfg, num_layers=4) if arch.startswith("llama4") else cfg


@pytest.mark.parametrize("arch", list(TC.ARCH_IDS))
def test_llm_bounds_keep_their_recorded_values(arch):
    cfg = _llm_config(arch)
    model = ttf.Transformer(cfg, META)
    assert round(tra.decode_bound_ms(model), 2) == DECODE_BOUNDS[arch]
    for length, ms in PREFILL_BOUNDS[arch]:
        assert tra.prefill_bound_ms(cfg, model, length, 4) == pytest.approx(ms, rel=1e-12)


def test_train_bounds_keep_their_recorded_values():
    from repro_torch.launch import train_llm
    for (arch, layers), (ms, by) in TRAIN_BOUNDS.items():
        cfg = TC.get(arch) if layers is None else dataclasses.replace(TC.get(arch),
                                                                      num_layers=layers)
        got = tra.train_bound_ms(cfg, 4, 2048)
        assert got[1] == by and got[0] == pytest.approx(ms, rel=1e-12)
        assert round(got[0], 1) == {"yi-9b": 85.2, "deepseek-moe-16b": 28.3,
                                    "rwkv6-3b": 144.4}[arch]
        assert tra.train_memory_gib(cfg, 4, 2048)["total"] == pytest.approx(TRAIN_GIB[arch],
                                                                            rel=1e-12)
    cfg = dataclasses.replace(TC.get_smoke("yi-9b"), **train_llm.PRESETS["100m"],
                              dtype=torch.float32)
    ms, by = tra.train_bound_ms(cfg, 2, 64)
    assert by == "bytes" and ms == pytest.approx(1.288500422686567, rel=1e-12)
    assert round(ms, 1) == 1.3


def test_plain_versions_run_uncounted_inside_the_counter():
    """``ref`` itself is plain torch: called directly under the counter its
    ops count, so the kernel ops pause the counter around it."""
    q = torch.zeros((1, 16, 1, 64))
    direct = counts.count(lambda: ref.attention_ref(q, q, q))[1]
    through_op = counts.count(lambda: ops.flash_attention(q, q, q, causal=False))[1]
    assert direct.flops == 2 * 2 * 16 * 16 * 64 and not direct.kernel_calls
    assert through_op.flops == fa.cost(q, q, q, causal=False)[0] == 4.0 * 16 * 16 * 64
    assert through_op.by_op.keys() == {"flash_attention"}


def test_counting_leaves_no_hook_behind():
    with pytest.raises(ValueError):
        counts.count(lambda: (_ for _ in ()).throw(ValueError("in the step")))
    assert ops.COUNTER is None
