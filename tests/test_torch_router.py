"""The port's router (``repro_torch.serve.router``) against the reference's.

Every case of ``tests/test_router.py`` (prefix keys, affinity, the
imbalance override, the least-depth fallback, forgetting a dead replica,
the empty fleet, tenant-fair order) runs through both routers on the same
inputs, with that test's own assertions on each, and the two must record
the same placements, keys, stats and orders. A seeded sequence of random
placements, depth changes and forgets over three page sizes is the last
case. Pure host logic: no model, no device work.
"""
import numpy as np
import pytest

from repro.serve import router as rrouter
from repro.serve.scheduler import StreamRequest as RRequest

from repro_torch.serve import router as prouter
from repro_torch.serve.scheduler import StreamRequest

SIDES = {"reference": (rrouter, RRequest), "port": (prouter, StreamRequest)}


class FakeReplica:
    def __init__(self, slot, depth=0):
        self.slot = slot
        self.depth = depth

    def queue_depth(self):
        return self.depth


def _req(cls, rid, prompt, arrival=0.0, tenant=None):
    return cls(rid=rid, prompt=list(prompt), max_new=4, arrival=arrival,
               tenant=tenant)


def case_prefix_key(mod, cls):
    r = mod.Router(page_size=4)
    keys = [r.prefix_key(p) for p in ([1, 2, 3], [1, 2, 3, 4],
                                      [1, 2, 3, 4, 9, 9])]
    assert keys == [None, (1, 2, 3, 4), (1, 2, 3, 4)]
    off = mod.Router(mod.RouterConfig(affinity=False),
                     page_size=4).prefix_key([1, 2, 3, 4])
    no_page = mod.Router(page_size=0).prefix_key([1, 2, 3, 4])
    assert off is None and no_page is None
    return keys


def case_same_prefix(mod, cls):
    r = mod.Router(page_size=4)
    reps = [FakeReplica(0), FakeReplica(1), FakeReplica(2)]
    sys_prompt = [7, 7, 7, 7]
    first = r.place(_req(cls, 0, sys_prompt + [1]), reps)
    first.depth += 1
    slots = [first.slot]
    for i in range(1, 5):
        rep = r.place(_req(cls, i, sys_prompt + [i + 1]), reps)
        assert rep.slot == first.slot     # follows the claim despite depth
        rep.depth += 1
        slots.append(rep.slot)
    assert r.stats["affinity_hits"] == 4
    return slots, r.stats


def case_imbalance(mod, cls):
    r = mod.Router(mod.RouterConfig(max_depth_imbalance=2), page_size=4)
    reps = [FakeReplica(0, depth=0), FakeReplica(1, depth=0)]
    home = r.place(_req(cls, 0, [7, 7, 7, 7, 1]), reps)
    assert home.slot == 0                 # least depth, lowest slot
    reps[0].depth = 5                     # home now 5 deeper than replica 1
    moved = r.place(_req(cls, 1, [7, 7, 7, 7, 2]), reps)
    assert moved.slot == 1
    assert r.stats["affinity_overridden"] == 1
    follower = r.place(_req(cls, 2, [7, 7, 7, 7, 3]), reps)
    assert follower.slot == 1             # the claim moved with it
    return [home.slot, moved.slot, follower.slot], r.stats


def case_no_key(mod, cls):
    r = mod.Router(page_size=4)
    reps = [FakeReplica(0, depth=3), FakeReplica(1, depth=1),
            FakeReplica(2, depth=1)]
    slot = r.place(_req(cls, 0, [1, 2]), reps).slot
    assert slot == 1                      # depth tie -> low slot
    return slot, r.stats


def case_forget(mod, cls):
    r = mod.Router(page_size=4)
    reps = [FakeReplica(0), FakeReplica(1, depth=9)]
    first = r.place(_req(cls, 0, [7, 7, 7, 7]), reps).slot
    assert first == 0
    released = r.forget_replica(0)
    assert released == 1
    # claim gone: placement re-judges by depth among survivors
    after = r.place(_req(cls, 1, [7, 7, 7, 7]), [reps[1]]).slot
    assert after == 1
    return first, released, after, r.stats


def case_no_replicas(mod, cls):
    with pytest.raises(RuntimeError, match="no live replicas") as e:
        mod.Router(page_size=4).place(_req(cls, 0, [1, 2, 3, 4]), [])
    return str(e.value)


def case_fair_interleave(mod, cls):
    burst = [_req(cls, i, [1], arrival=0.0, tenant="a") for i in range(4)]
    single = [_req(cls, 10, [1], arrival=0.0, tenant="b")]
    rids = [r.rid for r in mod.Router.fair_order(burst + single)]
    # tenant b's lone request lands second, not behind the whole burst
    assert rids == [0, 10, 1, 2, 3]
    return rids


def case_fair_stable(mod, cls):
    reqs = [_req(cls, 2, [1], arrival=1.0, tenant="a"),
            _req(cls, 0, [1], arrival=0.0, tenant="a"),
            _req(cls, 5, [1], arrival=0.5, tenant="b"),
            _req(cls, 3, [1], arrival=2.0, tenant="b"),
            _req(cls, 9, [1], arrival=0.0)]            # None -> default
    a = [r.rid for r in mod.Router.fair_order(reqs)]
    b = [r.rid for r in mod.Router.fair_order(list(reversed(reqs)))]
    assert a == b                                  # input-order independent
    pos = {rid: i for i, rid in enumerate(a)}
    assert pos[0] < pos[2] and pos[5] < pos[3]     # (arrival, rid) in tenant
    return a


def case_random_sequence(mod, cls):
    """Seeded placements over 4 replicas whose depths move, with forgets,
    three page sizes and affinity on and off; then tenant-fair orders of
    random windows."""
    out = []
    for page_size, affinity in ((2, True), (4, True), (4, False)):
        rng = np.random.default_rng(page_size + 10 * affinity)
        r = mod.Router(mod.RouterConfig(affinity=affinity,
                                        max_depth_imbalance=2),
                       page_size=page_size)
        reps = [FakeReplica(s) for s in range(4)]
        for rid in range(60):
            if rng.random() < 0.1:
                out.append(("forget", r.forget_replica(
                    int(rng.integers(0, 4)))))
            live = [rep for rep in reps if rng.random() < 0.9] or reps
            prompt = [int(t) for t in rng.integers(0, 3, rng.integers(1, 7))]
            rep = r.place(_req(cls, rid, prompt), live)
            rep.depth += int(rng.integers(0, 3))
            reps[int(rng.integers(0, 4))].depth = int(rng.integers(0, 6))
            out.append(rep.slot)
        out.append(dict(r.stats))
        window = [_req(cls, i, [1], arrival=float(rng.integers(0, 3)),
                       tenant=[None, "a", "b", "c"][int(rng.integers(0, 4))])
                  for i in range(20)]
        out.append([q.rid for q in mod.Router.fair_order(window)])
    return out


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


@pytest.mark.parametrize("case", list(CASES))
def test_router_case_matches_reference(case):
    got = {side: CASES[case](*mods) for side, mods in SIDES.items()}
    assert got["port"] == got["reference"]


def test_module_surface_matches_reference():
    assert prouter.DEFAULT_TENANT == rrouter.DEFAULT_TENANT
    assert prouter.RouterConfig() == prouter.RouterConfig(
        **vars(rrouter.RouterConfig()))
