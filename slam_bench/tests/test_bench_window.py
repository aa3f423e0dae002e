"""The window's work: the same takes for every seed, in the seed's order,
played in whole rounds, so that no seed's window does more work than
another's."""

import time

import pytest
import torch

from slam_bench import harness


def takes(seed, count=3):
    cell = harness.Readings(traffic={"scene": {"noise": 2.0}, "takes": count})
    setup = harness.Setup(clean=torch.full((2, 6, 5), 100.0))
    return harness.takes_of(cell, setup, seed)


def test_every_seed_has_the_same_takes_in_its_own_order():
    a, b = takes(2147483901), takes(3100000013)
    key = lambda ts: sorted(t.sum().item() for t in ts)
    assert key(a) == key(b)
    assert len({t.sum().item() for t in a}) == 3
    orders = {tuple(harness.take_order(s, 3)) for s in range(2147483648, 2147483668)}
    assert len(orders) > 1
    assert all(sorted(o) == [0, 1, 2] for o in orders)
    # the same seed, the same takes in the same order
    assert all(torch.equal(x, y) for x, y in zip(a, takes(2147483901)))


@pytest.mark.parametrize("episode_s", [0.0, 0.004, 0.011])
def test_the_window_ends_with_the_round_that_crosses_its_mark(monkeypatch, episode_s):
    played = []

    def episode(s, snap, frames, per_call, on_call=None, labels=None):
        played.append(frames)
        time.sleep(episode_s)
        on_call(len(frames), episode_s, [object()] * len(frames))

    monkeypatch.setattr(harness, "episode", episode)
    t = ["a", "b", "c"]
    _, window_s, lat, failed, n_ep = harness.measure(None, None, t, 8, 0.02)
    assert window_s >= 0.02 and failed == 0
    assert n_ep == len(played) and n_ep % 3 == 0 and n_ep >= 3
    assert played == t * (n_ep // 3)
    assert len(lat) == sum(map(len, played))
