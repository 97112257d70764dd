"""The scheduler's replica axis against the JAX package's ``SlotScheduler``.

A (data, model) mesh splits the slot array into data replicas: flat slot
``i`` lives on replica ``i // (n_slots / n_replicas)``, each admission
goes to the least-loaded replica that can take it (ties to the lowest),
under a per-replica FLOP budget and the paged engine's
``page_check(handle, replica)``, and ``set_replicas`` re-derives the axis
at a live re-mesh. One seeded trace of submissions (tenant classes,
budgets as costs), admissions with capped and scaled costs and a page
check that refuses some (handle, replica) pairs, frees, preemptions,
reprices, ticks, ``set_replicas`` and ``reset_stats`` runs through both
packages' schedulers; the slot and the replica of every admission, the
queue, ``replica_used_cost``, ``free_slots_in``, ``flop_budget`` and
``replica_occupancy`` must agree after every operation. Host only: no
model, no processes.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.runtime import scheduler as JS  # noqa: E402
from repro_torch.runtime import scheduler as TS  # noqa: E402

N_SLOTS = 8
OPS = 160


class _Req:
    def __init__(self, slo_class):
        self.slo_class = slo_class


def _script(S, seed: int, n_replicas: int, flop_budget):
    rng = np.random.default_rng(seed)
    sch = S.SlotScheduler(N_SLOTS, flop_budget, n_replicas)
    hs, idx, trace = [], {}, []

    def state():
        R = sch.n_replicas
        return (sch.n_replicas, sch.slots_per_replica, sch.flop_budget,
                [round(sch.replica_used_cost(r), 12) for r in range(R)],
                [sch.free_slots_in(r) for r in range(R)],
                [round(o, 12) for o in sch.replica_occupancy],
                [idx[h.id] for h, _ in sch.queue],
                [None if h is None else idx[h.id] for h in sch.slots])

    for _ in range(OPS):
        op = int(rng.integers(0, 9))
        if op <= 2:                                   # submissions
            for _ in range(int(rng.integers(1, 4))):
                h = S.RequestHandle(_Req(str(rng.choice(["a", "b"]))))
                h.tenant = h.request.slo_class
                idx[h.id] = len(hs)
                hs.append(h)
                sch.enqueue(h, float(rng.choice([1.0, 0.75, 0.5, 0.25])))
        elif op <= 4:                                 # admissions
            deny = {(int(a), int(b)) for a, b in
                    rng.integers(0, max(1, len(hs)), (3, 2))}
            check = (None if rng.uniform() < 0.5 else
                     lambda h, r: (idx[h.id] % 7, r) not in deny)
            cap = None if rng.uniform() < 0.6 else 0.5
            scale = None if rng.uniform() < 0.7 else 0.75
            got = sch.admit(page_check=check, cost_cap=cap, cost_scale=scale)
            trace.append(("admit", [(slot, sch.replica_of(slot), idx[h.id])
                                    for slot, h in got]))
        elif op == 5:                                 # finish or preempt
            busy = [i for i, h in enumerate(sch.slots) if h is not None]
            if busy:
                slot = int(rng.choice(busy))
                h, cost = sch.slots[slot], sch.costs[slot]
                sch.free(slot)
                if rng.uniform() < 0.3:
                    sch.requeue_front(h, cost)
                else:
                    h.finish("length")
        elif op == 6:
            busy = [i for i, h in enumerate(sch.slots) if h is not None]
            if busy:
                sch.reprice(int(rng.choice(busy)),
                            float(rng.choice([0.5, 0.125])))
        elif op == 7:                                 # a live re-mesh
            r = int(rng.choice([1, 2, 4]))
            sch.set_replicas(r)
            trace.append(("set_replicas", r))
            if rng.uniform() < 0.2:
                sch.reset_stats()
        else:
            sch.tick()
        trace.append(state())
    trace.append((sch.steps, round(sch.occupancy, 12),
                  [(h.status, h.slot) for h in hs]))
    return trace


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("flop_budget", [None, 1.5])
def test_replica_placement_matches_jax(seed, flop_budget):
    """Two replicas (re-meshed to 1, 2 and 4 along the trace): every
    admission's slot and replica, the per-replica cost, free slots, FLOP
    budget and occupancy as the JAX scheduler's."""
    got = _script(TS, seed, 2, flop_budget)
    assert got == _script(JS, seed, 2, flop_budget)
    admits = [a for kind, *a in (t for t in got if t[0] == "admit")]
    placed = {rep for (rows,) in admits for _, rep, _ in rows}
    assert placed >= {0, 1}


def test_ties_go_to_the_lowest_replica_and_budgets_rescale():
    for S in (TS, JS):
        sch = S.SlotScheduler(4, None, 2)
        assert (sch.flop_budget, sch.replica_of(1), sch.replica_of(2)) == \
            (2.0, 0, 1)
        hs = [S.RequestHandle(_Req("default")) for _ in range(3)]
        for h in hs:
            h.tenant = "default"
            sch.enqueue(h, 1.0)
        assert [(s, sch.replica_of(s)) for s, _ in sch.admit()] == [
            (0, 0), (2, 1), (1, 0)]
        sch.set_replicas(1)
        assert sch.flop_budget == 4.0 and sch.replica_occupancy == [0.0]
        with pytest.raises(ValueError):
            sch.set_replicas(3)
        assert S.SlotScheduler(4, 1.5, 2).flop_budget == 1.5
