"""The traffic generator: the same work for every seed, the order and the
mels from the seed, and lengths as the mix states them."""

import json
import os
import statistics

import numpy as np
import pytest

from portbench.traffic import Mix, seed_for

from .conftest import ROOT


def mix(name):
    with open(os.path.join(ROOT, "portbench", "traffic", f"{name}.json")) as f:
        return Mix(json.load(f), 22050, 256)


@pytest.mark.parametrize("name", ["offline-b16", "utt-b1"])
def test_round_is_the_same_set_of_calls_for_every_seed(name):
    m = mix(name)
    calls = m.calls
    assert calls == m.round_calls()
    assert len(calls) == m.per_round
    assert all(len(c) == m.batch for c in calls)
    # every call inside one bucket
    assert all(m.padded(max(c)) == m.padded(min(c)) for c in calls)
    orders = [m.order(seed, 0) for seed in (1, 2, 2 ** 33 + 5)]
    for order in orders:
        assert sorted(order) == list(range(m.per_round))
    assert not np.array_equal(orders[0], orders[1])
    assert np.array_equal(m.order(7, 3), m.order(7, 3))
    assert not np.array_equal(m.order(7, 3), m.order(7, 4))
    # the same buckets' sequence for every seed and round
    for order in orders + [m.order(7, 3)]:
        assert [m.padded(max(calls[i])) for i in order] == m.slots


def test_every_stretch_of_calls_carries_the_mix():
    m = mix("offline-b16")
    mass = m.bucket_mass()
    for start in range(0, 64, 7):
        for n in (7, 16, 32):
            stretch = [m.slots[(start + j) % 64] for j in range(n)]
            for edge, p in mass.items():
                share = sum(1 for b in m.slots if b == edge) / 64
                assert abs(stretch.count(edge) - n * share) <= 1.5


@pytest.mark.parametrize("name", ["offline-b16", "utt-b1"])
def test_lengths_follow_ljspeech(name):
    m = mix(name)
    frames = [f for c in m.calls for f in c]
    seconds = [f / m.rate for f in frames]
    # LJSpeech 1.1: 1.11-10.10 s, mean 6.57 s; the normal clipped to
    # that range with a 2.2 s deviation puts its mean near 6.5 s
    assert min(frames) == m.frames(1.11) == 96
    assert max(frames) == m.frames(10.10) == 870
    assert 6.3 < statistics.mean(seconds) < 6.65
    assert 1.9 < statistics.stdev(seconds) < 2.3
    buckets = {m.padded(f) for f in frames}
    assert buckets == {128, 256, 384, 512, 640, 768, 896}


def test_bucket_shares_follow_the_distribution():
    m = mix("offline-b16")
    mass = m.bucket_mass()
    assert sum(mass.values()) == pytest.approx(1.0)
    counts = {}
    for c in m.calls:
        counts[m.padded(max(c))] = counts.get(m.padded(max(c)), 0) + 1
    assert counts == {128: 1, 256: 3, 384: 7, 512: 14, 640: 17, 768: 13,
                      896: 9}
    for edge, n in counts.items():
        assert abs(n - 64 * mass[edge]) <= 1


def test_warm_calls_cover_each_shape_once():
    m = mix("offline-b16")
    calls = m.calls
    warm = m.warm_calls()
    shapes = [(len(calls[i]), m.padded(max(calls[i]))) for i in warm]
    assert len(shapes) == len(set(shapes)) == 7


def test_seed_streams_take_large_and_negative_seeds():
    seeds = {seed_for(s, 4, k) for s in (0, 1, 2 ** 31 + 7, 2 ** 40, -3)
             for k in (0, 1)}
    assert len(seeds) == 10
    assert all(0 <= s < 2 ** 63 for s in seeds)
    assert seed_for(2 ** 31 + 7, 4, 1) == seed_for(2 ** 31 + 7, 4, 1)
