"""The H100 80GB MIG catalog of the port (``topology/mig.py``): the fixed
profile table, InstaSlice's profile-name rule, and placements on the
port's placement engine worked by hand from the catalog and InstaSlice's
first-fit rule (the first free start slot of the first GPU that has
one). Each case has a control that must fail. Tolerance: exact."""

import pytest

from instaslice_tpu_torch.topology import frag, placement, policy, profiles
from instaslice_tpu_torch.topology import mig

FF = policy.get_policy("first-fit")


def _take(group, occ, name):
    """First-fit ``name`` and occupy it: (GPU, start), or None."""
    pl = FF.choose(group, mig.parse_mig_profile(name), occ)
    if pl is None:
        return None
    occ.occupy(pl.box)
    return mig.box_gpu_start(pl.box)


def _at(occ, name, gpu, start):
    p = mig.parse_mig_profile(name)
    box = mig.slot_box(gpu, start, p.memory_slices)
    assert start in p.starts
    occ.occupy(box)


def test_catalog_table():
    got = {p.name: (p.memory_slices, p.compute_slices, p.memory_gb,
                    p.starts, p.profile_id)
           for p in mig.mig_catalog(mig.H100_80GB)}
    assert got == {
        "1g.10gb": (1, 1, 10, (0, 1, 2, 3, 4, 5, 6), 19),
        "1g.20gb": (2, 1, 20, (0, 2, 4, 6), 15),
        "2g.20gb": (2, 2, 20, (0, 2, 4), 14),
        "3g.40gb": (4, 3, 40, (0, 4), 9),
        "4g.40gb": (4, 4, 40, (0,), 5),
        "7g.80gb": (8, 7, 80, (0,), 0),
    }
    # every start leaves the profile inside the GPU's 8 slots
    for p in mig.mig_catalog(mig.H100_80GB):
        assert all(0 <= s and s + p.memory_slices <= mig.SLOTS
                   for s in p.starts)
        assert p.hbm_gib() == p.memory_gb and p.hosts_needed() == 1
    assert mig.mig_catalog("v5e") is None
    assert [p.name for p in profiles.profile_catalog(mig.H100_80GB)] == \
        [p.name for p in mig.mig_catalog(mig.H100_80GB)]


@pytest.mark.parametrize("name,want", [
    ("nvidia.com/mig-1g.10gb", "1g.10gb"),
    ("nvidia.com/mig-3g.40gb", "3g.40gb"),
    ("MIG 7g.80gb", "7g.80gb"),
    ("2g.20gb", "2g.20gb"),
    (" 4g.40gb ", "4g.40gb"),
    ("nvidia.com/gpu", "gpu"),
    ("gpu", "gpu"),
])
def test_parse_names(name, want):
    assert mig.parse_mig_profile(name).name == want


@pytest.mark.parametrize("name", [
    "nvidia.com/mig-1g", "nvidia.com/mig-1g.5", "3g-40gb", "", "v5e-2x2",
    "nvidia.com/mig-1g.5gb", "nvidia.com/mig-8g.80gb",
])
def test_parse_malformed_or_unknown_raises(name):
    with pytest.raises(ValueError):
        mig.parse_mig_profile(name)


def test_seven_1g10gb_fill_a_gpu():
    g = mig.gpu_group(1)
    occ = placement.Occupancy(g)
    got = [_take(g, occ, "1g.10gb") for _ in range(7)]
    assert got == [(0, s) for s in range(7)]
    # full: no eighth, and nothing else fits either (slot 7 is stranded)
    assert _take(g, occ, "1g.10gb") is None
    for p in mig.mig_catalog(mig.H100_80GB):
        assert FF.choose(g, p, occ) is None
    m = frag.frag_metrics(g, occ)
    assert (m.free_chips, m.largest_free_box, m.stranded_free_chips) == \
        (1, "", 1)
    # control: with one 1g.10gb released, the next lands in its slot
    occ.release(mig.slot_box(0, 3, 1))
    assert _take(g, occ, "1g.10gb") == (0, 3)


def test_4g40gb_at_0_beside_3g40gb_at_4():
    g = mig.gpu_group(1)
    occ = placement.Occupancy(g)
    assert _take(g, occ, "4g.40gb") == (0, 0)
    assert _take(g, occ, "3g.40gb") == (0, 4)
    assert FF.choose(g, mig.parse_mig_profile("1g.10gb"), occ) is None
    # control: 4g.40gb has one start, so a second is refused even on a
    # GPU whose slots 4-7 are free
    occ2 = placement.Occupancy(g)
    _at(occ2, "4g.40gb", 0, 0)
    assert _take(g, occ2, "4g.40gb") is None
    assert _take(g, occ2, "3g.40gb") == (0, 4)


def test_three_2g20gb_then_1g10gb_at_6():
    g = mig.gpu_group(1)
    occ = placement.Occupancy(g)
    assert [_take(g, occ, "2g.20gb") for _ in range(3)] == \
        [(0, 0), (0, 2), (0, 4)]
    assert _take(g, occ, "2g.20gb") is None     # 2g.20gb has no start 6
    assert _take(g, occ, "1g.10gb") == (0, 6)
    # control: 1g.20gb (starts 0, 2, 4, 6) would have fit at 6 instead
    occ2 = placement.Occupancy(g)
    for s in (0, 2, 4):
        _at(occ2, "2g.20gb", 0, s)
    assert _take(g, occ2, "1g.20gb") == (0, 6)


@pytest.mark.parametrize("taken", [(0, 1), (3, 1), (7, 1), (4, 4)])
def test_7g80gb_refused_once_any_slot_is_taken(taken):
    g = mig.gpu_group(1)
    occ = placement.Occupancy(g)
    # control: on an empty GPU it fits at 0
    assert FF.choose(g, mig.parse_mig_profile("7g.80gb"), occ) is not None
    occ.occupy(mig.slot_box(0, *taken))
    assert _take(g, occ, "7g.80gb") is None
    assert _take(g, occ, "gpu") is None


def test_first_fit_walks_the_gpus_in_order():
    g = mig.gpu_group(3)
    occ = placement.Occupancy(g)
    assert _take(g, occ, "7g.80gb") == (0, 0)
    assert _take(g, occ, "3g.40gb") == (1, 0)
    assert _take(g, occ, "4g.40gb") == (2, 0)
    assert _take(g, occ, "3g.40gb") == (1, 4)
    assert _take(g, occ, "gpu") is None
    assert _take(g, occ, "2g.20gb") == (2, 4)
    pl = FF.choose(g, mig.parse_mig_profile("1g.10gb"), placement
                   .Occupancy(g))
    assert pl.parts[0].node_name == "gpu0"


@pytest.mark.parametrize("name", policy.policy_names())
def test_every_policy_places_only_legal_starts(name):
    g = mig.gpu_group(2)
    occ = placement.Occupancy(g)
    pol = policy.get_policy(name)
    order = ["1g.10gb", "3g.40gb", "2g.20gb", "1g.20gb", "4g.40gb",
             "1g.10gb", "7g.80gb", "2g.20gb"]
    for n in order:
        pl = pol.choose(g, mig.parse_mig_profile(n), occ)
        if pl is None:
            continue
        gpu, start = mig.box_gpu_start(pl.box)
        assert start in mig.parse_mig_profile(n).starts and gpu in (0, 1)
        occ.occupy(pl.box)
    m = frag.frag_metrics(g, occ)
    assert m.total_chips == 16 and 0 <= m.free_chips < 16
