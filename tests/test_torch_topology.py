"""The port's placement engine (``instaslice_tpu_torch.topology``) held
exactly equal to the JAX package's (``instaslice_tpu.topology``).

Seeded numpy sequences of choose/occupy/release/block run through both
packages side by side, on every generation of the reference's registry
and every policy of ``policy_names()``, over a one-host group, a
two-host group and a sparse four-host group: the chosen placements, the
``FragMetrics`` after each step and every exception (type and message)
must be equal. Tolerance: exact.
"""

import dataclasses

import numpy as np
import pytest

from instaslice_tpu.topology import frag as jfrag
from instaslice_tpu.topology import grid as jgrid
from instaslice_tpu.topology import placement as jplace
from instaslice_tpu.topology import policy as jpolicy
from instaslice_tpu.topology import profiles as jprof
from instaslice_tpu_torch.topology import frag as tfrag
from instaslice_tpu_torch.topology import grid as tgrid
from instaslice_tpu_torch.topology import placement as tplace
from instaslice_tpu_torch.topology import policy as tpolicy
from instaslice_tpu_torch.topology import profiles as tprof

J = (jgrid, jplace, jpolicy, jprof, jfrag)
T = (tgrid, tplace, tpolicy, tprof, tfrag)
GENS = sorted(jgrid.GENERATIONS)
STEPS = 40


def _group(pkg, gen_name: str, kind: str):
    """A group of ``kind``: "one" host, "two" hosts along x, or "sparse":
    a 2x2 block of hosts with the (1, 1) host missing."""
    grid = pkg[0]
    gen = grid.get_generation(gen_name)
    hb = gen.host_bounds
    if kind == "one":
        return grid.TorusGroup.single_host("node-a", gen)
    tiles = [(0, 0), (1, 0)] if kind == "two" else [(0, 0), (0, 1), (1, 0)]
    bounds = (hb[0] * 2, hb[1] * (2 if kind == "sparse" else 1), hb[2])
    hosts = {
        f"node-{i}": grid.NodeGrid(gen, (tx * hb[0], ty * hb[1], 0), "g")
        for i, (tx, ty) in enumerate(tiles)
    }
    return grid.TorusGroup("g", gen, bounds, hosts)


def _pl(p):
    if p is None:
        return None
    return (p.profile.name, p.group_id, p.box.key(),
            tuple((h.node_name, h.worker_id, h.local_box.key())
                  for h in p.parts))


def _outcome(fn):
    """("ok", value) or (exception type, message). An unknown
    generation's message lists the known ones, and the port knows one
    more (the H100's MIG grid): that list is cut off."""
    try:
        return ("ok", fn())
    except (ValueError, KeyError) as e:
        return (type(e).__name__, str(e).split("; known:")[0])


def test_generation_registry_holds_the_references():
    for name in GENS:
        assert dataclasses.asdict(tgrid.GENERATIONS[name]) == \
            dataclasses.asdict(jgrid.GENERATIONS[name])
    assert tpolicy.policy_names() == jpolicy.policy_names()


@pytest.mark.parametrize("gen", GENS)
def test_catalog_names_and_legal_placements_equal(gen):
    for kind in ("one", "two", "sparse"):
        gj, gt = _group(J, gen, kind), _group(T, gen, kind)
        cj = jprof.profile_catalog(gen, gj.chip_count)
        ct = tprof.profile_catalog(gen, gt.chip_count)
        assert [(p.name, p.shape) for p in cj] == \
            [(p.name, p.shape) for p in ct]
        for pj, pt in zip(cj, ct):
            assert pj.attributes() == pt.attributes()
            assert jprof.orientations(gj.generation, pj.shape) == \
                tprof.orientations(gt.generation, pt.shape)
            assert [_pl(p) for p in jplace.legal_placements(gj, pj)] == \
                [_pl(p) for p in tplace.legal_placements(gt, pt)]


@pytest.mark.parametrize("name", [
    "v5e-2x2", "v5e-1x4", "v5e-4x1", "v4-2x2x2", "v4-2x2x1", "v5p-4x4x4",
    "v6e-8x16", "v5e-3x2", "v5e-2x2x2", "v7-2x2", "v5e", "v5e-32x32",
    " v5e-2x4 ", "v4-16x16x16",
])
def test_parse_profile_name_equal(name):
    def parse(prof):
        def run():
            p = prof.parse_profile_name(name)
            return (p.name, p.shape, p.chip_count, p.hosts_needed())
        return run
    assert _outcome(parse(jprof)) == _outcome(parse(tprof))


@pytest.mark.parametrize("gen", GENS)
@pytest.mark.parametrize("policy", jpolicy.policy_names())
def test_seeded_sequences_equal(gen, policy):
    for k, kind in enumerate(("one", "two", "sparse")):
        gj, gt = _group(J, gen, kind), _group(T, gen, kind)
        oj, ot = jplace.Occupancy(gj), tplace.Occupancy(gt)
        pj, pt = jpolicy.get_policy(policy), tpolicy.get_policy(policy)
        cat_j = jprof.profile_catalog(gen, gj.chip_count)
        cat_t = tprof.profile_catalog(gen, gt.chip_count)
        rng = np.random.default_rng(1000 * k + GENS.index(gen))
        live = {}                     # owner -> (box J, box T)
        n = 0
        for _ in range(STEPS):
            r = rng.random()
            if r < 0.25 and live:
                owner = sorted(live)[int(rng.integers(len(live)))]
                bj, bt = live.pop(owner)
                oj.release(bj, owner)
                ot.release(bt, owner)
            elif r < 0.32:
                # a foreign release: an owner that holds nothing
                assert _outcome(lambda: oj.release(
                    jplace.Box((0, 0, 0), (1, 1, 1)), "ghost")) == \
                    _outcome(lambda: ot.release(
                        tplace.Box((0, 0, 0), (1, 1, 1)), "ghost"))
            elif r < 0.37:
                c = tuple(int(rng.integers(b)) for b in gj.bounds)
                oj.block([c])
                ot.block([c])
            else:
                i = int(rng.integers(len(cat_j)))
                cj, ct = (pj.choose(gj, cat_j[i], oj),
                          pt.choose(gt, cat_t[i], ot))
                assert _pl(cj) == _pl(ct), (kind, cat_j[i].name)
                if cj is not None:
                    n += 1
                    owner = f"o{n}"
                    oj.occupy(cj.box, owner)
                    ot.occupy(ct.box, owner)
                    live[owner] = (cj.box, ct.box)
                    # the same box again: both refuse with one message
                    assert _outcome(lambda: oj.occupy(cj.box)) == \
                        _outcome(lambda: ot.occupy(ct.box))
                # an out-of-bounds box: both refuse
                far = tuple(b for b in gj.bounds)
                assert _outcome(lambda: oj.occupy(
                    jplace.Box(far, (1, 1, 1)))) == _outcome(
                    lambda: ot.occupy(tplace.Box(far, (1, 1, 1))))
            mj, mt = jfrag.frag_metrics(gj, oj), tfrag.frag_metrics(gt, ot)
            assert dataclasses.asdict(mj) == dataclasses.asdict(mt)
            assert mj.stranded_fraction == mt.stranded_fraction
            assert jfrag.snapshot_line(mj) == tfrag.snapshot_line(mt)
            assert oj.taken == ot.taken
        assert n > 0


def test_unknown_names_raise_alike():
    assert _outcome(lambda: jpolicy.get_policy("v9")) == \
        _outcome(lambda: tpolicy.get_policy("v9"))
    assert _outcome(lambda: jgrid.get_generation("v9")) == \
        _outcome(lambda: tgrid.get_generation("v9"))


def test_box_keys_and_group_validation_equal():
    for key in ("2,0,0+2x2x1", "0,4,0+1x1x1", "1,2+3x4", "a+b"):
        assert _outcome(lambda: jplace.Box.from_key(key).key()) == \
            _outcome(lambda: tplace.Box.from_key(key).key())
    gen_j, gen_t = (jgrid.get_generation("v5e"),
                    tgrid.get_generation("v5e"))
    for bounds, offs in (((3, 4, 1), [(0, 0, 0)]),
                         ((4, 4, 1), [(1, 0, 0)]),
                         ((4, 4, 1), [(0, 0, 0), (0, 0, 0)]),
                         ((2, 4, 1), [(0, 4, 0)])):
        def mk(grid, gen):
            return lambda: grid.TorusGroup("g", gen, bounds, {
                f"h{i}": grid.NodeGrid(gen, o) for i, o in enumerate(offs)
            }).chip_count
        assert _outcome(mk(jgrid, gen_j)) == _outcome(mk(tgrid, gen_t))
