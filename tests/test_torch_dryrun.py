"""The port's dry run (``launch/dryrun.py``, ``launch/dryrun_pipeline.py``)
on ``meta`` over fake worlds, on the CPU; the roofline table and the
kernel microbenchmarks of ``repro_torch.benchmarks``.

``internvl2-2b decode_32k`` runs on an 8x8 fake world as the reference's
dry-run test runs it on 64 host devices; the CLI's ``yi-9b decode_32k`` and
``dryrun_pipeline --pipeline sd3`` end ``ok`` without a card, and the world
is torn down after each combination.
"""
import json

import pytest
import torch
import torch.distributed as dist

import repro.configs as JC
from repro.launch import specs as jspecs
import repro_torch.configs as TC
from repro_torch.benchmarks import kernels_bench
from repro_torch.benchmarks import roofline as bench_roofline
from repro_torch.benchmarks import run as bench
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, dryrun_pipeline
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import specs as tspecs
from repro_torch.models import transformer as ttf
from repro_torch.roofline import counts
from repro_torch.sharding import spmd
from repro_torch.sharding.partition import P

MESH_8x8 = mesh_lib.MeshShape(("data", "model"), (8, 8))
KEYS = {"status", "hlo_flops_per_device", "hlo_bytes_per_device", "coll_wire_bytes_total",
        "coll_counts", "model_flops", "t_compute_s", "t_memory_s", "t_collective_s",
        "bottleneck", "useful_ratio", "peak_mem_per_device", "t_trace_s"}


def _ok(rec):
    assert rec["status"] == "ok", rec.get("traceback", rec)
    assert KEYS <= set(rec)
    assert rec["hlo_flops_per_device"] > 0 and rec["hlo_bytes_per_device"] > 0
    assert not dist.is_initialized()


def test_internvl2_decode_on_an_8x8_fake_world():
    rec = dryrun.run_one("internvl2-2b", "decode_32k", verbose=False, mesh_shape=MESH_8x8)
    _ok(rec)
    assert rec["mesh"] == "8x8" and rec["kind"] == "decode"
    assert rec["kernel_calls"] == {}          # decode attends to the cache in plain torch
    assert rec["coll_counts"] and rec["t_collective_s"] > 0
    # the reference's model FLOPs of the same step
    from repro.roofline import analysis as jra
    assert rec["model_flops"] == pytest.approx(
        jra.model_flops(JC.get("internvl2-2b"), "decode", 128, 32768), rel=1e-12)


def test_cli_yi9b_decode_ends_ok(tmp_path, capsys):
    out = tmp_path / "d.jsonl"
    assert dryrun.main(["--arch", "yi-9b", "--shape", "decode_32k", "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert "every data and model group is wider" in text and "yi-9b" in text
    (rec,) = [json.loads(line) for line in out.read_text().splitlines()]
    _ok(rec)
    # one device holds 1/256 of the caches: 48 layers of (128, 32768, 4, 128) bf16 k and v
    assert rec["peak_mem_per_device"] >= 48 * 2 * 128 * 32768 * 4 * 128 * 2 / 256


def test_cli_pipeline_sd3_ends_ok(tmp_path, capsys):
    out = tmp_path / "p.jsonl"
    assert dryrun_pipeline.main(["--pipeline", "sd3", "--out", str(out)]) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["arch"] for r in recs] == ["sd3-dit", "sd3-ae"]
    for r in recs:
        _ok(r)
    cfg = TC.get("sd3").dit
    assert recs[0]["kernel_calls"] == {"adaln_rmsnorm": 2 * cfg.num_layers + 1,
                                       "flash_attention": cfg.num_layers}


def test_a_pipeline_case_on_the_smoke_sd3():
    cfg = TC.get_smoke("sd3")
    recs = dryrun_pipeline.run_case("sd3", cfg=cfg, case=(256, 0.0, 16), verbose=False)
    for r in recs:
        _ok(r)
    assert recs[0]["kernel_calls"]["flash_attention"] == cfg.dit.num_layers
    assert recs[0]["model_flops"] > 0 and recs[1]["model_flops"] > 0


def test_skipped_combinations_start_no_world():
    rec = dryrun.run_one("yi-9b", "long_500k", verbose=False)
    assert rec["status"] == "skipped"
    assert rec["reason"] == jspecs.input_specs("yi-9b", "long_500k").skipped
    assert not dist.is_initialized()


def test_an_error_is_recorded_and_the_world_torn_down(monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("a broken step")

    spec = tspecs.input_specs("zamba2-1.2b", "decode_32k", TC.get_smoke("zamba2-1.2b"))
    monkeypatch.setattr(tspecs, "input_specs",
                        lambda *a, **k: tspecs.LoweringSpec(spec.kind, broken, spec.args,
                                                            spec.arg_names, spec.batch,
                                                            spec.seq_len))
    rec = dryrun.run_one("zamba2-1.2b", "decode_32k", verbose=False,
                         cfg=TC.get_smoke("zamba2-1.2b"), mesh_shape=MESH_8x8)
    assert rec["status"] == "error" and "a broken step" in rec["error"]
    assert not dist.is_initialized() and ops.COUNTER is None


def test_shardings_follow_the_reference_rules():
    """The batch shards over data where it divides (else replicates), the
    decode cache's sequence over model, the moments over data with zero."""
    cfg = TC.get("rwkv6-3b")
    long = tspecs.input_specs("rwkv6-3b", "long_500k", cfg)
    pspec, tokens, cspec, offset = dryrun.shardings_for(long, cfg, mesh_lib.make_production_mesh(),
                                                        False)
    assert tokens == P(None, None) and offset is None
    cfg = TC.get_smoke("yi-9b")
    dec = tspecs.input_specs("yi-9b", "decode_32k", cfg)
    _, tokens, cspec, _ = dryrun.shardings_for(dec, cfg, MESH_8x8, False)
    assert tokens == P("data", None) and cspec[0]["k"] == P("data", "model", None, None)
    train = tspecs.input_specs("yi-9b", "train_4k", cfg)
    sspec, bspec = dryrun.shardings_for(train, cfg, MESH_8x8, False, frozenset({"zero"}))
    assert bspec["tokens"] == P("data", None)
    assert "data" in tuple(sspec.opt.mu["layers.0.wq"])
    assert "data" not in tuple(sspec.params["layers.0.wq"])
    multi = dryrun.shardings_for(train, cfg, mesh_lib.make_production_mesh(multi_pod=True), True)
    assert multi[1]["tokens"] == P(("pod", "data"), None)


def test_seqshard_sets_the_activation_spec_for_the_step_only(monkeypatch):
    seen = []
    real = ttf.set_activation_sharding
    monkeypatch.setattr(ttf, "set_activation_sharding", lambda s: (seen.append(s), real(s)))
    rec = dryrun.run_one("yi-9b", "train_4k", verbose=False, opts=frozenset({"seqshard"}),
                         cfg=TC.get_smoke("yi-9b"), mesh_shape=MESH_8x8)
    _ok(rec)
    assert seen == [P("data", "model", None), None]
    assert ttf._ACTIVATION_SPEC is None


def test_unsupported_calls_run_replicated_and_are_named():
    """A reshape that splits a sharded dimension unevenly: DTensor refuses
    it, the call runs again on the replicated input (an all-gather), and an
    in-place call writes back into its argument in its placements."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    with counts.fake_world(4):
        mesh = mesh_lib.build(mesh_lib.MeshShape(("data", "model"), (1, 4)), "cpu")
        x = DTensor.from_local(torch.zeros((2, 6)), mesh, [Replicate(), Shard(1)],
                               run_check=False, shape=(2, 24), stride=(24, 1))
        with spmd.replicate_unsupported() as fb:
            y = x.reshape(2, 2, 12)
            x.add_(1)
        assert dict(fb.calls) == {"reshape": 1}
        assert y.shape == (2, 2, 12)
        assert x.placements == (Replicate(), Shard(1))
        with pytest.raises(RuntimeError):
            x.reshape(2, 2, 12)                 # outside the mode DTensor refuses it


def test_reshape_gathers_a_dimension_that_does_not_split_and_its_gradient_too():
    """``spmd.reshape`` of a dimension sharded 4 ways into (2, 12): the
    input is gathered whole first, and the gradient takes the same path
    back (the training pass's recompute runs outside any mode); a plain
    tensor reshapes as ``Tensor.reshape`` does, a view of the same bits."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    plain = torch.arange(48.0).reshape(2, 24)
    view = spmd.reshape(plain, 2, 2, 12)
    assert torch.equal(view, plain.reshape(2, 2, 12)) and view.data_ptr() == plain.data_ptr()
    with counts.fake_world(4):
        mesh = mesh_lib.build(mesh_lib.MeshShape(("data", "model"), (1, 4)), "cpu")
        x = DTensor.from_local(torch.ones((2, 6)), mesh, [Replicate(), Shard(1)],
                               run_check=False, shape=(2, 24), stride=(24, 1)).requires_grad_()
        y = spmd.reshape(x, 2, 2, 12)
        assert y.shape == (2, 2, 12)
        y.sum().backward()
        assert x.grad.shape == (2, 24)
        assert torch.equal(x.grad.full_tensor(), torch.ones((2, 24)))


def test_roofline_rows_from_records(tmp_path):
    rows = bench_roofline.run(results=str(tmp_path))
    assert [r[0] for r in rows] == [f"roofline/{f}/missing" for f in bench_roofline.FILES]
    rec = {"arch": "yi-9b", "shape": "decode_32k", "mesh": "16x16", "status": "ok",
           "hlo_flops_per_device": 989e12, "hlo_bytes_per_device": 3.35e12 * 2,
           "coll_wire_bytes_total": 900e9 + 100e9, "coll_wire_bytes_wide": 100e9,
           "useful_ratio": 0.5, "peak_mem_per_device": 2 ** 31}
    skipped = {"arch": "yi-9b", "shape": "long_500k", "mesh": "16x16", "status": "skipped",
               "reason": "pure full-attention stack"}
    (tmp_path / bench_roofline.FILES[0]).write_text(json.dumps(rec) + "\n" + json.dumps(skipped))
    rows = bench_roofline.run(results=str(tmp_path))
    name, value, derived = rows[0]
    assert name == "roofline/yi-9b/decode_32k/16x16/t_collective_ms" and value == 3000.0
    assert derived["compute_ms"] == 1000.0 and derived["memory_ms"] == 2000.0
    assert derived["peak_mem_GiB"] == 2.0
    assert rows[1][0] == "roofline/yi-9b/long_500k/16x16/skipped"
    from repro_torch.core.profiler import REFERENCE_HW
    ref_rows = bench_roofline.run(results=str(tmp_path), hw=REFERENCE_HW)
    assert ref_rows[0][2]["collective_ms"] == pytest.approx(1000e9 / 50e9 * 1e3)


def test_kernel_microbenchmarks_time_the_plain_versions():
    rows = kernels_bench.run()
    assert [r[0] for r in rows] == ["kernels/attention_ref_512/us_per_call",
                                    "kernels/linear_scan_ref_1024/us_per_call",
                                    "kernels/adaln_rmsnorm_ref/us_per_call"]
    assert all(r[1] > 0 for r in rows)
    assert bench.ROOFLINE_MODULES == ["kernels_bench", "roofline"]
    assert bench.main(["--only", "roofline"]) == 0
