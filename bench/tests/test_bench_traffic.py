"""The traffic generator: the log-normal fit to a trace's median and
mean, the cut, and the same schedule for every seed."""
import json

import numpy as np
import pytest

from bench.harness import traffic
from bench.tests import _tiny


def _mix(**kw):
    mix = json.loads((_tiny.REPO / "bench" / "traffic" /
                      "azure-conv-s32.json").read_text())
    mix.update(kw)
    return mix


def test_lognormal_keeps_the_published_median_and_mean():
    dist = {"dist": "lognormal", "median": 1020, "mean": 1155, "min": 1,
            "max": 10 ** 6}
    x = traffic._lengths(np.random.default_rng(1), 200_000, dist, 1.0)
    assert np.median(x) == pytest.approx(1020, rel=0.01)
    assert x.mean() == pytest.approx(1155, rel=0.01)


def test_the_cut_scales_lengths_and_clips_them():
    mix = _mix()
    ps = traffic.sizes(mix, 5000)
    assert np.median(ps[:, 0]) == pytest.approx(1020 / 16, rel=0.05)
    assert np.median(ps[:, 1]) == pytest.approx(129 / 16, rel=0.1)
    assert ps.min() >= 1 and (ps.sum(1) <= mix["max_len"]).all()
    assert ps[:, 0].max() <= mix["prompt_len"]["max"]


def test_every_seed_runs_the_same_schedule_with_its_own_tokens():
    mix = _mix()
    a = traffic.requests(mix, 2 ** 31 + 5, 51, 49152)
    b = traffic.requests(mix, 7, 51, 49152)
    assert len(a) == traffic.request_count(mix, 51) == 337
    assert [(len(r.prompt), r.steps) for r in a] == \
        [(len(r.prompt), r.steps) for r in b]
    assert any((r.prompt != q.prompt).any() for r, q in zip(a, b))
    assert all(0 <= r.prompt.min() and r.prompt.max() < 49152 for r in a)
