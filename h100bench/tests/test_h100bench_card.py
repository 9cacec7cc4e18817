"""Every cell of ``BENCHMARK.json`` at its configuration's tiny size on
the card, through the port's CUDA path: run with ``python -m pytest
--noconftest -p no:cacheprovider -m cuda h100bench/tests`` on a machine
with a card; skipped without one."""

import pytest

from h100bench.tests.helpers import cells, run_tiny


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", cells())
@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_run_on_the_card_is_correct(card, cell, trace):
    r = run_tiny(cell, device="cuda", trace=trace)
    assert r["correct"] is True, r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["memory_peak_bytes"] > 0
    if trace:
        assert r["device"]["busy_s"] > 0
