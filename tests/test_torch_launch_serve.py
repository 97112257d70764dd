"""The port's serving CLI (``repro_torch.launch.serve``) against the JAX
package's ``repro.launch.serve`` on the CPU: the argument parsers, the
latency and per-replica reports on the same handle timestamps, the
scheduler's occupancy window on the same trace, ``open_loop``'s greedy
tokens on toy-lm (f32, JAX on its jnp oracles), ``main``'s report lines,
``--mesh 1,2`` (two gloo ranks on the CPU, spawned by ``main``) serving
the one-device run's tokens, and the CLI's refusals (a mesh without a
backend or with a controller, ``--remesh-at`` without a mesh and an open
loop, shapes that do not fit). ``--mesh 2,2`` and ``--remesh-at`` are
served in tests/test_torch_dp.py.

``main``'s lines are compared by their heads (``open loop:``,
``latency:``, ...). JAX's toy-lm default elastic config moefies the MLP
and its paged ``main`` prints a ``[serve]`` notice that it drops those
experts; the port's toy-lm default has none to drop, so that notice is
left out of the comparison.
"""
import argparse
import dataclasses
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs one process per core

from repro.launch import serve as jserve  # noqa: E402
from repro.runtime import scheduler as jsched  # noqa: E402
from repro.training import GenRequest as JaxRequest  # noqa: E402
from repro.training import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import workloads  # noqa: E402
from repro_torch.runtime import scheduler as tsched  # noqa: E402
from repro_torch.training import GenRequest, ServingEngine  # noqa: E402
from tests.test_torch_interop import RouterMargins, toy_pair  # noqa: E402


def _outcome(fn, s):
    try:
        return ("ok", fn(s))
    except argparse.ArgumentTypeError as e:
        return ("error", str(e))


@pytest.mark.parametrize("s", ["0.5", "0.25,0.5,1.0", "1", "1.0,0.1", "0",
                               "1.5", "-0.25", "a", "0.5,x", "", "0.5,,1"])
def test_budget_list_matches_jax(s):
    assert _outcome(tserve._budget_list, s) == \
        _outcome(jserve._budget_list, s)


@pytest.mark.parametrize("s", ["2,4", "1,1", "8,1", "0,4", "2,-1", "2",
                               "a,b", "2,4,1", ""])
def test_mesh_shape_matches_jax(s):
    assert _outcome(tserve._mesh_shape, s) == _outcome(jserve._mesh_shape, s)


# ------------------------- reports on the same handles -----------------------

class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _handles(pkg, clock):
    """Five handles of one script on ``pkg``'s RequestHandle: served ones
    with per-token stamps, one rejected, one never finished."""
    rng = np.random.default_rng(4)
    out = []
    clock.t = 0.0
    for i in range(5):
        h = pkg.RequestHandle(None, clock=clock)
        h.slot = i % 3
        clock.t += float(rng.uniform(0.01, 0.2))
        if i == 3:
            h.finish("rejected")
        elif i < 4:
            for _ in range(int(rng.integers(1, 6))):
                clock.t += float(rng.uniform(0.001, 0.05))
                h.append(1)
            h.finish("length")
        out.append(h)
    return out


def test_latency_stats_match_jax():
    assert tserve.latency_stats is workloads.latency_stats
    t, j = _handles(tsched, _Clock()), _handles(jsched, _Clock())
    assert tserve.latency_stats(t) == jserve.latency_stats(j)
    assert tserve.latency_stats([]) == jserve.latency_stats([])
    assert tserve.latency_stats(t[:1] + [None]) == \
        jserve.latency_stats(j[:1] + [None])


def _tick_trace(sched, pkg, clock):
    """A trace of submits, admissions, ticks and frees; the stats window
    reset halfway."""
    hs = [pkg.RequestHandle(None, clock=clock) for _ in range(6)]
    for h, cost in zip(hs, (1.0, 0.5, 0.25, 1.0, 0.75, 0.5)):
        sched.enqueue(h, cost)
    sched.admit()
    snaps = []
    for step in range(12):
        sched.tick()
        if step in (2, 5, 8):
            sched.free(next(i for i, s in enumerate(sched.slots)
                            if s is not None))
            sched.admit()
        if step == 6:
            snaps.append((sched.occupancy, list(sched.replica_occupancy)))
            sched.reset_stats()
        snaps.append((sched.steps, sched.active_slot_steps,
                      sched.occupancy, list(sched.replica_occupancy)))
    return snaps


@pytest.mark.parametrize("flop_budget", [None, 1.5])
def test_occupancy_window_matches_jax(flop_budget):
    ours = tsched.SlotScheduler(4, flop_budget)
    theirs = jsched.SlotScheduler(4, flop_budget)
    assert ours.n_replicas == theirs.n_replicas == 1
    assert ours.replica_occupancy == theirs.replica_occupancy == [0.0]
    trace = _tick_trace(ours, tsched, _Clock())
    assert trace == _tick_trace(theirs, jsched, _Clock())
    assert all(snap[-1] == [snap[-2]] for snap in trace)


def _stub_engine(sched_mod, handles, remeshed_at):
    sched = sched_mod.SlotScheduler(3)
    for h in handles[:3]:
        sched.enqueue(h, 1.0)
    sched.admit()
    for _ in range(4):
        sched.tick()
    sched.free(0)
    sched.tick()
    return type("Engine", (), {"scheduler": sched,
                               "remeshed_at": remeshed_at})()


@pytest.mark.parametrize("remeshed_at", [None, 0.3])
def test_replica_report_matches_jax(remeshed_at):
    ct, cj = _Clock(), _Clock()
    t, j = _handles(tsched, ct), _handles(jsched, cj)
    got = tserve.replica_report(_stub_engine(tsched, t, remeshed_at), t)
    want = jserve.replica_report(_stub_engine(jsched, j, remeshed_at), j)
    assert got == want and "replica 0:" in got


# ------------------------------- open_loop -----------------------------------

BATCH, MAX_SEQ, NEW = 3, 48, 6
BUDGETS = [1.0, 0.5, None, 0.75, 0.5]


@pytest.fixture(scope="module")
def setup():
    s = toy_pair(seed=2)
    s["jspec"] = dataclasses.replace(s["jspec"], kernel_backend="ref")
    rng = np.random.default_rng(5)
    s["prompts"] = [rng.integers(0, s["tcfg"].vocab_size, n,
                                 dtype=np.int64).astype(np.int32)
                    for n in (10, 17, 12, 24, 9)]
    return s


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_open_loop_gives_the_jax_engines_tokens(setup, monkeypatch, layout):
    """Both packages' ``open_loop`` on the same arrival schedule: every
    handle done, the port's greedy tokens equal JAX's, and each handle's
    ``t_submit`` is its scheduled arrival."""
    s = setup
    kw = dict(mode="infer", batch_size=BATCH, max_seq=MAX_SEQ,
              kv_layout=layout)
    arrive = np.array([0.0, 0.0, 0.02, 0.04, 0.05])
    jeng = JaxEngine(s["params"], s["rp"], s["jcfg"], s["jspec"], **kw)
    jh, _ = jserve.open_loop(jeng, [JaxRequest(p, NEW, budget=b) for p, b
                                    in zip(s["prompts"], BUDGETS)], 0.0,
                             arrive=arrive)
    margins = RouterMargins(monkeypatch)
    teng = ServingEngine(s["tparams"], s["trp"], s["tcfg"], s["tspec"],
                         device="cpu", **kw)
    t0 = time.perf_counter()
    th, elapsed = tserve.open_loop(
        teng, [GenRequest(p, NEW, budget=b) for p, b in
               zip(s["prompts"], BUDGETS)], 0.0, arrive=arrive)
    margins.check()
    assert all(h.status == "done" for h in th)
    assert [list(h.output) for h in th] == \
        [[int(x) for x in h.output] for h in jh]
    offsets = [h.t_submit - t0 for h in th]
    assert all(abs(o - a) < 0.05 for o, a in zip(offsets, arrive))
    assert elapsed >= arrive[-1]


def test_open_loop_poisson_schedule_is_jaxs(monkeypatch):
    """Without ``arrive`` both draw Poisson gaps from
    ``default_rng(seed)``: the same schedule reaches ``replay``."""
    seen = {}
    monkeypatch.setattr(tserve, "replay", lambda eng, reqs, arrive, **kw: (
        seen.setdefault("arrive", arrive), ([None] * len(reqs), 0.0, {}))[1])
    tserve.open_loop(object(), [None] * 6, 4.0, seed=3)
    want = np.cumsum(np.random.default_rng(3).exponential(0.25, 6))
    np.testing.assert_array_equal(seen["arrive"], want)


def test_refusals_cite_item_11(setup, monkeypatch, capsys):
    s = setup
    with pytest.raises(ValueError, match="mesh engine"):
        tserve.open_loop(object(), [], 1.0, remesh_at=2, remesh_to=(1, 1))
    eng = ServingEngine(s["tparams"], s["trp"], s["tcfg"], s["tspec"],
                        batch_size=2, max_seq=MAX_SEQ, device="cpu",
                        clock=workloads.StepClock(0.1))
    with pytest.raises(ValueError, match=r"replay\(.*clock="):
        tserve.open_loop(eng, [GenRequest(s["prompts"][0], 2)], 1.0)
    for argv, err in ((["--mesh", "2,4"], "--backend"),
                      (["--remesh-at", "4"], "requires --mesh"),
                      (["--remesh-to", "1,2"], "requires --mesh"),
                      (["--mesh", "2,2", "--batch", "3"], "multiple"),
                      (["--mesh", "2,2", "--arrival-rate", "8",
                        "--remesh-at", "2", "--remesh-to", "4,2"], "fit")):
        with pytest.raises(SystemExit):
            tserve.main(argv + ["--device", "cpu"])
        assert err in capsys.readouterr().err
    with pytest.raises(SystemExit):        # parsed first, as in JAX
        tserve.main(["--mesh", "2"])
    assert "'data,model' int pair" in capsys.readouterr().err
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tserve.main(["--requests", "1"])


# ---------------------------------- main -------------------------------------

MAIN = ["--arch", "toy-lm", "--requests", "4", "--batch", "2",
        "--prompt-len", "8", "--max-new", "4", "--budget", "0.5,1.0"]


def _heads(text):
    return {ln.split(":")[0].split(" ")[0] if not ln.startswith("open loop")
            else "open loop" for ln in text.splitlines()
            if ln and not ln.startswith("[serve]")}


@pytest.mark.parametrize("extra", [
    ["--arrival-rate", "50", "--controller", "--kv-layout", "paged"],
    ["--arrival-rate", "50", "--controller"],
    ["--kv-layout", "paged"],
    [],
], ids=["open-paged", "open-ring", "closed-paged", "closed-ring"])
def test_main_prints_jaxs_report_lines(monkeypatch, capsys, extra):
    monkeypatch.setattr(sys, "argv", ["serve"] + MAIN + extra)
    jserve.main()
    want = capsys.readouterr().out
    tserve.main(MAIN + extra + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert _heads(got) == _heads(want), (got, want)
    heads = _heads(got)
    assert "compiles" in heads
    assert ("paged" in heads) == ("paged" in extra)
    assert ("open loop" in heads) == ("--arrival-rate" in extra)


def test_mesh_2_2_serves_and_remeshes_live(capfd, monkeypatch):
    """``--mesh 2,2 --backend gloo`` spawns four CPU ranks (two replicas of
    two model shards) serving the one-device run's sample tokens; in the
    open loop ``--remesh-at 2 --remesh-to 1,2`` re-meshes the live engine
    once at least two requests are submitted (ranks 2 and 3 leave), and
    rank 0 prints
    the report with the per-replica window since the re-mesh."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")     # the spawned ranks'
    argv = MAIN + ["--device", "cpu", "--max-new", "6"]
    tserve.main(argv)
    one = capfd.readouterr().out
    mesh = argv + ["--mesh", "2,2", "--backend", "gloo"]
    tserve.main(mesh)
    four = capfd.readouterr().out
    pick = lambda text, head: [ln for ln in text.splitlines()
                               if ln.startswith(head)]
    for head in ("sample output", "compiles"):
        assert pick(four, head) == pick(one, head) != []
    tserve.main(mesh + ["--arrival-rate", "50", "--remesh-at", "2",
                        "--remesh-to", "1,2"])
    out = capfd.readouterr().out
    line = pick(out, "[serve] re-meshed live to (data, model)=(1, 2) after")
    assert len(line) == 1 and int(line[0].split()[8]) >= 2
    assert len(pick(out, "open loop:")) == 1
    assert pick(out, "  (per-replica window: since the live re-mesh")
    assert len(pick(out, "  replica ")) == 1          # one replica after
    assert pick(out, "compiles") == pick(one, "compiles")


def test_mesh_1_2_serves_the_one_device_tokens(capfd, monkeypatch):
    """``--mesh 1,2 --backend gloo`` spawns two CPU ranks, each serving its
    shard; rank 0 alone prints, the one-device run's sample tokens and
    compile counts. Without ``--backend`` the mesh is refused."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")     # the spawned ranks'
    argv = MAIN + ["--device", "cpu", "--max-new", "6"]
    tserve.main(argv)
    one = capfd.readouterr().out
    tserve.main(argv + ["--mesh", "1,2", "--backend", "gloo"])
    two = capfd.readouterr().out
    pick = lambda text, head: [ln for ln in text.splitlines()
                               if ln.startswith(head)]
    assert len(pick(two, "served")) == 1
    for head in ("sample output", "compiles"):
        assert pick(two, head) == pick(one, head) != []
    with pytest.raises(SystemExit):
        tserve.main(argv + ["--mesh", "1,2"])
    assert "--backend" in capfd.readouterr().err
    with pytest.raises(SystemExit):        # ranks on their own clocks
        tserve.main(argv + ["--mesh", "1,2", "--backend", "gloo",
                            "--controller"])
    assert "controller on a mesh" in capfd.readouterr().err
