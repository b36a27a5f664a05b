"""The end-to-end metrics' arithmetic over a window with a stall."""

import pytest

from perfbench import harness


def test_rate_and_p90_with_one_stall():
    lat = [0.2] * 20 + [2.0]
    m = harness.window_metrics(lat, 128, sum(lat))
    assert m["frames_per_s"] == pytest.approx(21 * 128 / 6.0)
    # 21 values: the 90th percentile is the 19th smallest, 0.2 s
    assert m["chunk_ms_p90"] == pytest.approx(200.0)


def test_p90_between_order_statistics():
    lat = [0.2] * 9 + [2.0]
    m = harness.window_metrics(lat, 128, 3.8)
    # position 0.9 * 9 = 8.1: 0.2 + 0.1 * (2.0 - 0.2)
    assert m["chunk_ms_p90"] == pytest.approx(380.0)
    assert m["frames_per_s"] == pytest.approx(10 * 128 / 3.8)


def test_one_chunk_window():
    m = harness.window_metrics([0.25], 128, 0.25)
    assert m == {"frames_per_s": 512.0, "chunk_ms_p90": 250.0}
