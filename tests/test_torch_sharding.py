"""The port's sharded paths on worlds of 2 and 4 CPU ranks (gloo) against
the reference.

Each world is started once (``shard_check.World``, a ``file://`` rendezvous
in a fresh temporary directory, no fixed port) and runs every check of its
size: Ulysses attention against the reference's single-device attention
(and, at 4 ranks, its own 4-device ``ulysses_attention`` in one JAX
subprocess); the chunk-parallel scan against the reference's sequential
oracle, at the limits of ``tests/test_sharding.py`` (its own chunk-parallel
scan is not the oracle: it fails on this JAX and runs the chunked scan at
chunk 32); the sharded train step against the port's unsharded step from
the reference's state, and its first loss against the reference's; and,
at 4 ranks, the checks' negative controls on the known faults of
``test_torch_sharding_faults``.
"""
import functools
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.configs as JC
from repro.data import pipeline as jdp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.training import loop as jloop
from repro_torch.launch import shard_check as sc
from repro_torch.launch import train as launch_train

import test_torch_sharding_faults as faults

ROOT = os.path.join(os.path.dirname(__file__), "..")
ATTN_TOL = 2e-5          # tests/test_sharding.py's Ulysses limit
SCAN_TOL = 3e-3          # its scan limit (atol and rtol)
STEP_TOL = 1e-5          # loss, gradient norm, aux loss, parameters (of their rms)
UPDATE_TOL = 1e-3        # rms of each parameter's error over the rms of its steps
MOMENT_TOL = 1e-4        # each moment element against its own value plus the rms
ATTN = {n: [sc.AttnCase("causal", 2, 8 * n, 2 * n, 16, causal=True, seed=1),
            sc.AttnCase("softcap", 1, 8 * n, n, 16, softcap=5.0, seed=2),
            sc.AttnCase("causal-softcap", 2, 4 * n, n, 8, causal=True, softcap=3.0, seed=3)]
        for n in (2, 4)}
SCAN = {n: [sc.ScanCase("bonus", 2, 3, 16 * n, 8, 8, True, seed=4),
            sc.ScanCase("inclusive", 2, 3, 16 * n, 8, 8, False, layout="zamba2", seed=5),
            sc.ScanCase("floor-bonus", 1, 3, 16 * n, 8, 8, True, floor=True, seed=6),
            sc.ScanCase("floor", 1, 3, 16 * n, 8, 8, False, floor=True, seed=7)]
        for n in (2, 4)}
# deepseek-moe at 4 x 1024 tokens: each rank's batch row is one routing
# group (1024 tokens), so the MoE routes each rank's own groups
TRAIN = {4: [sc.TrainCase("deepseek-moe-16b", (2, 2), opts)
             for opts in ((), ("zero",), ("fsdp",), ("seqshard",))]
         + [sc.TrainCase("deepseek-moe-16b", (2, 2), ("fsdp",), seq=1024)],
         2: [sc.TrainCase(arch, mesh) for arch in ("yi-9b", "rwkv6-3b")
             for mesh in ((2, 1), (1, 2))]}
DROPPED = [sc.TrainCase("deepseek-moe-16b", (2, 2), ("zero",))]   # layers.0.wq not updated


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


@functools.lru_cache(maxsize=None)
def _state(arch):
    """The reference's initial state as numpy (params, mu, nu, step)."""
    js = jloop.init_state(JC.get_smoke(arch), jax.random.PRNGKey(0))
    n = _np(js)
    return n.params, n.opt.mu, n.opt.nu, int(js.opt.step)


@functools.lru_cache(maxsize=None)
def _first_loss(arch, batch, seq):
    """The reference's first step's loss on the cases' batch."""
    cfg = JC.get_smoke(arch)
    params = jax.tree_util.tree_map(jnp.asarray, _state(arch)[0])
    nb = jdp.synthetic_batch(cfg, jdp.DataConfig(batch=batch, seq_len=seq), 0)
    loss, _ = jax.jit(lambda p, b: jloop.loss_fn(cfg, p, b))(
        params, {k: jnp.asarray(v) for k, v in nb.items()})
    return float(loss)


def _ulysses_4dev(tmp_path):
    """Start the reference's 4-device ``ulysses_attention`` on ATTN[4]'s
    inputs in a JAX subprocess -> (the process, where it writes)."""
    inp, out = tmp_path / "ulysses_in.npz", tmp_path / "ulysses_out.npz"
    arrays = {}
    for i, case in enumerate(ATTN[4]):
        for name, t in zip("qkv", sc.attn_inputs(case, "cpu")):
            arrays[f"{name}{i}"] = t.numpy()
    np.savez(inp, **arrays)
    flags = [(c.causal, c.softcap) for c in ATTN[4]]
    code = textwrap.dedent(f"""
        import jax, jax.numpy as jnp, numpy as np
        from repro.sharding import sequence_parallel as sp
        mesh = jax.make_mesh((4,), ("model",))
        a = np.load({str(inp)!r})
        out = {{}}
        for i, (causal, softcap) in enumerate({flags!r}):
            q, k, v = (jnp.asarray(a[f"{{n}}{{i}}"]) for n in "qkv")
            out[str(i)] = np.asarray(sp.ulysses_attention(q, k, v, mesh, causal=causal,
                                                          softcap=softcap))
        np.savez({str(out)!r}, **out)
    """)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds' results, and the reference's 4-device Ulysses outputs."""
    tmp = tmp_path_factory.mktemp("sharding")
    proc, out_path = _ulysses_4dev(tmp)
    try:
        states = {n: {c.arch: _state(c.arch) for c in cases} for n, cases in TRAIN.items()}
        started = {4: sc.World(4, faults.faulty_suite, ATTN[4], SCAN[4], TRAIN[4], states[4],
                               DROPPED, device="cpu", timeout=600),
                   2: sc.World(2, sc.suite_ranks, ATTN[2], SCAN[2], TRAIN[2], states[2],
                               device="cpu", timeout=600)}
        res = {n: w.wait()[0] for n, w in started.items()}
        _, err = proc.communicate(timeout=300)
    finally:
        for w in locals().get("started", {}).values():
            w.close()
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    res["jax_4dev"] = dict(np.load(out_path))
    return res


def _attn_oracle(case):
    q, k, v = (jnp.asarray(t.numpy()) for t in sc.attn_inputs(case, "cpu"))
    return np.asarray(jops.flash_attention(q, k, v, causal=case.causal, softcap=case.softcap,
                                           use_kernel=False))


def _attn_agrees(got, case) -> bool:
    return np.allclose(got.numpy(), _attn_oracle(case), atol=ATTN_TOL, rtol=0)


def _scan_oracle(case):
    q, k, v, decay, bonus = (None if t is None else jnp.asarray(t.float().numpy())
                             for t in sc.scan_inputs(case, "cpu"))
    return [np.asarray(t) for t in jref.linear_scan_ref(q, k, v, decay, bonus)]


def _scan_agrees(got, case) -> bool:
    want = _scan_oracle(case)
    return all(np.allclose(g.float().numpy(), w, atol=SCAN_TOL, rtol=SCAN_TOL)
               for g, w in zip(got, want))


@pytest.mark.parametrize("n,i", [(n, i) for n in (2, 4) for i in range(len(ATTN[n]))])
def test_ulysses_matches_the_references_single_device_attention(worlds, n, i):
    case = ATTN[n][i]
    got = worlds[n]["ulysses"]["outputs"][i]
    assert got.shape == (case.b, case.l, case.h, case.d)
    np.testing.assert_allclose(got.numpy(), _attn_oracle(case), atol=ATTN_TOL, rtol=0)


@pytest.mark.parametrize("i", range(len(ATTN[4])))
def test_ulysses_matches_the_references_4dev_ulysses(worlds, i):
    np.testing.assert_allclose(worlds[4]["ulysses"]["outputs"][i].numpy(),
                               worlds["jax_4dev"][str(i)], atol=ATTN_TOL, rtol=0)


@pytest.mark.parametrize("n,i", [(n, i) for n in (2, 4) for i in range(len(SCAN[n]))])
def test_scan_chunk_parallel_matches_the_sequential_oracle(worlds, n, i):
    case = SCAN[n][i]
    out, state = worlds[n]["scan"]["outputs"][i]
    want_out, want_state = _scan_oracle(case)
    assert np.isfinite(out.numpy()).all() and np.isfinite(state.numpy()).all()
    np.testing.assert_allclose(out.float().numpy(), want_out, atol=SCAN_TOL, rtol=SCAN_TOL)
    np.testing.assert_allclose(state.numpy(), want_state, atol=SCAN_TOL, rtol=SCAN_TOL)


@pytest.mark.parametrize("n,i", [(n, i) for n in (4, 2) for i in range(len(TRAIN[n]))])
def test_sharded_train_step_matches_the_unsharded_step_and_the_reference(worlds, n, i):
    """Two steps sharded against two unsharded, from the reference's state:
    the loss, aux loss and gradient norm of each step at STEP_TOL; after
    the second step every parameter that was not zero at the start within
    STEP_TOL of its rms, and every parameter's steps (its value minus its
    start, the only measure of the zero-initialised norm weights) within
    UPDATE_TOL in rms (the largest element reads AdamW's rounding near
    |g| ~ eps: about 2e-2 of the steps' rms here); every AdamW moment
    element within MOMENT_TOL of its own value plus the tensor's rms, and
    within STEP_TOL of the tensor's largest value. The first loss also
    matches the reference's."""
    case = TRAIN[n][i]
    row = worlds[n]["train"][i]
    assert (row["arch"], row["mesh"], row["opts"]) == (case.arch, "x".join(map(str, case.mesh)),
                                                       ",".join(case.opts))
    assert len(row["steps"]) == case.steps
    assert max(row["loss"], row["grad_norm"], row["aux"]) <= STEP_TOL, row
    assert row["params"] <= STEP_TOL and row["updates"] <= UPDATE_TOL, row
    assert row["moments"] <= MOMENT_TOL and row["moments_of_max"] <= STEP_TOL, row
    assert row["topk_differ"] == 0
    want = _first_loss(case.arch, case.batch, case.seq)
    for side in ("want", "got"):
        np.testing.assert_allclose(row["steps"][0][side]["loss"], want, rtol=STEP_TOL, atol=1e-7)
    assert row["launches"] == {"flash_attention": 0, "adaln_rmsnorm": 0, "ssm_scan": 0}


def test_the_checks_reject_a_wrong_all_to_all_and_a_wrong_ladder(worlds):
    """The same comparisons fail on the known faults (a Ulysses whose
    all-to-alls swap the sequence and head axes; a ladder that does not
    decay the prefix), and a length that does not divide is refused."""
    res = worlds[4]
    assert _attn_agrees(res["ulysses"]["outputs"][0], ATTN[4][0])
    assert not _attn_agrees(res["faults"]["a2a_swapped"]["outputs"][0], ATTN[4][0])
    assert _scan_agrees(res["scan"]["outputs"][0], SCAN[4][0])
    assert not _scan_agrees(res["faults"]["ladder_no_decay"]["outputs"][0], SCAN[4][0])
    assert "does not divide" in res["uneven"]


def test_the_checks_reject_a_sharded_step_that_drops_one_parameters_update(worlds):
    """With one parameter's update dropped on the mesh (its moments still
    updated), the loss stays within STEP_TOL: the parameter and update
    comparisons reject it, by far."""
    good, bad = worlds[4]["train"][1], worlds[4]["faults"]["dropped_update"][0]
    assert (bad["arch"], bad["opts"]) == (good["arch"], good["opts"]) == (DROPPED[0].arch, "zero")
    assert good["updates"] <= UPDATE_TOL and good["params"] <= STEP_TOL
    assert bad["loss"] <= STEP_TOL
    assert bad["updates"] > 100 * UPDATE_TOL and bad["worst_updates"] == "layers.0.wq", bad
    assert bad["params"] > STEP_TOL and bad["worst_params"] == "layers.0.wq", bad


def test_the_moe_routes_each_ranks_own_groups_where_they_fit(worlds):
    """On the 2x2 mesh the batch is sharded four ways. At 4 x 1024 tokens
    each rank's row is one whole routing group: rank 0 routes a quarter of
    the groups, with the same experts for every token as the unsharded
    step. At 4 x 16 tokens the one group spans every rank's rows: it is
    routed whole."""
    rows = worlds[4]["train"]
    kept, whole = rows[-1], rows[0]
    assert TRAIN[4][-1].seq == 1024
    assert kept["groups"]["all"] == 4 * kept["groups"]["rank0"] > 0
    assert kept["tokens"] == kept["groups"]["all"] * 1024 and kept["topk_differ"] == 0
    assert whole["groups"]["rank0"] == whole["groups"]["all"] > 0


def test_default_backend_counts_the_cards_of_this_node(monkeypatch):
    """nccl where this node's ranks (LOCAL_WORLD_SIZE) each have a card,
    whatever the world size across nodes; gloo where they share cards and
    on the CPU; an nccl world with more ranks on a node than cards is
    refused."""
    import torch
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert launch_train.default_backend(cuda, 8) == "nccl"
    assert launch_train.default_backend(cuda, 9) == "gloo"
    assert launch_train.default_backend(cpu, 1) == "gloo"
    monkeypatch.setenv("WORLD_SIZE", "16")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    assert launch_train.local_world() == 8
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "16")
    with pytest.raises(SystemExit, match="16 ranks on this node"):
        launch_train.card_of_rank(cuda, "nccl")


def test_global_norm_of_a_sharded_gradient_is_the_full_norm(worlds):
    """The gradient norm each step reports on a mesh is that of the full
    gradient (the unsharded step's), on every mesh and switch."""
    for n in (4, 2):
        for row in worlds[n]["train"]:
            for s in row["steps"]:
                np.testing.assert_allclose(s["got"]["grad_norm"], s["want"]["grad_norm"],
                                           rtol=STEP_TOL)


def test_launch_train_under_torchrun_on_a_2x1_mesh_with_zero():
    """``torchrun`` (a free port of its own) starts two ranks of
    ``launch.train --mesh 2x1 --opt zero``; rank 0 prints the first line
    with the backend and the step lines."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "2", "-m", "repro_torch.launch.train", "--arch", "rwkv6-3b", "--smoke", "--mesh", "2x1",
           "--opt", "zero", "--device", "cpu", "--steps", "3", "--batch", "4", "--seq", "16",
           "--log-every", "2"]
    out = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert any("mesh=2x1 world=2 backend=gloo opts=['zero']" in ln for ln in lines), out.stdout
    steps = [ln for ln in lines if ln.startswith("step ")]
    assert [ln.split()[1] for ln in steps] == ["0", "2"], out.stdout



def test_gloo_probe_runs_a_collective_on_two_cpu_ranks():
    """``launch.gloo_probe``'s rank function times one direct and one
    functional all-reduce over two CPU ranks."""
    from repro_torch.launch import gloo_probe
    for functional in (False, True):
        secs = sc.run(2, gloo_probe.collective_ranks, functional, "all_reduce", 1024,
                      device="cpu", timeout=120)
        assert len(secs) == 2 and all(s >= 0 for s in secs)
