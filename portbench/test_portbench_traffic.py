"""Seeded traffic is deterministic: the same seed draws the same readings,
points, sizes and sample; another seed draws others; every seed sends the
same set of sizes."""

import numpy as np
import pytest
import torch

from portbench import gen

BIG = 2**31 + 3  # the driver's seeds pass 32 signed bits


def test_item_seed_is_stable_and_spread():
    assert gen.item_seed(BIG, gen.READINGS, 5) == gen.item_seed(BIG, gen.READINGS, 5)
    seeds = {gen.item_seed(s, st, i) for s in (0, 1, BIG, 2**40) for st in (1, 2) for i in range(3)}
    assert len(seeds) == 24 and all(0 <= s < 2**63 for s in seeds)


def test_readings_repeat_per_item():
    spec = {"axis": 0, "amplitude": 1.0, "freq": [0.5, 2.0], "phase": [0.0, 6.28], "sigma": 0.3}
    x = torch.linspace(-1, 1, 17)
    g = torch.Generator()
    a = gen.readings(spec, x, 4, BIG, gen.READINGS, 3, g)
    b = gen.readings(spec, x, 4, BIG, gen.READINGS, 4, g)
    assert torch.equal(a, gen.readings(spec, x, 4, BIG, gen.READINGS, 3, g))
    assert not torch.equal(a, b) and a.shape == (4, 17)
    assert not torch.equal(a, gen.readings(spec, x, 4, BIG + 1, gen.READINGS, 3, g))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_points_repeat_and_stay_in_domain(dtype):
    g = torch.Generator()
    p = gen.points([-1.0, 1.0], 100, 2, BIG, 9, g, dtype)
    assert torch.equal(p, gen.points([-1.0, 1.0], 100, 2, BIG, 9, g, dtype))
    assert p.dtype == dtype and float(p.abs().max()) <= 1.0


def test_sizes_same_set_other_order():
    spec = {"q_min": 4096, "q_max": 65536, "count": 64}
    a, b = gen.sizes(spec, BIG), gen.sizes(spec, BIG + 1)
    assert a == gen.sizes(spec, BIG) and a != b and sorted(a) == sorted(b)
    assert min(a) == 4096 and max(a) == 65536 and len(a) == 64


def test_placement_is_the_deployments():
    cfg = {"domain": [-1.0, 1.0], "placement_seed": 0, "n_sensors": 50, "dim": 1}
    want = np.random.default_rng(0).uniform(-1.0, 1.0, size=(50, 1)).astype(np.float32)
    assert np.array_equal(gen.placement(cfg), want)


def test_reservoir_is_a_seeded_uniform_sample():
    def sample(seed, n):
        r = gen.Reservoir(3, seed)
        for i in range(n):
            slot = r.wants()
            if slot is not None:
                r.put(slot, i, i)
        return sorted(i for i, _ in r.kept)

    assert sample(BIG, 100) == sample(BIG, 100) and len(sample(BIG, 100)) == 3
    assert sample(BIG, 2) == [0, 1]
    hits = np.zeros(20)
    for s in range(400):
        hits[sample(s, 20)] += 1
    assert hits.min() > 0.5 * hits.mean()  # every position is drawn
