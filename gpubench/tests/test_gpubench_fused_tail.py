"""The reader of ``fused_tail_share.score`` on a synthetic store of the
port's counters: 100 with fused tails alone, 0 with plain tails alone, the
share in between, None with no tail counted or no profile."""

from __future__ import annotations

import types

import pytest

from gpubench.harness import ROOT, Benchmark


@pytest.mark.parametrize("counts,want", [
    ({"tail.fused": 384}, 100.0),
    ({"tail.plain": 24}, 0.0),
    ({"tail.fused": 3, "tail.plain": 1, "itm.slots": 9}, 75.0),
    ({"itm.slots": 9}, None),
    ({}, None),
])
def test_fused_tail_share_reads_the_tail_counters(monkeypatch, counts, want):
    from uniter_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "snapshot", lambda: {
        "spans": [], "counts": dict(counts), "totals": {}})
    read = Benchmark(ROOT).reader("fused_tail_share.score")
    assert read(types.SimpleNamespace(profile={"busy_s": 1.0})) == want
    assert read(types.SimpleNamespace(profile=None)) is None
