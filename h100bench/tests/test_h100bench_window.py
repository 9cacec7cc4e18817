"""The window's wall and CPU time, and the readers of the card's busy
time and the host's CPU time a call."""

from types import SimpleNamespace

from h100bench.harness import window
from h100bench.harness.manifest import Manifest
from h100bench.tests.helpers import ROOT


def _spin(cpu_seconds):
    """Burn ``cpu_seconds`` of this thread's CPU time."""
    t = window.time.thread_time()
    while window.time.thread_time() - t < cpu_seconds:
        pass
    return "out"


def test_the_window_keeps_its_calls_wall_and_cpu_time():
    win = window.run(lambda: _spin(0.05), 0.2, log=lambda msg: None)
    assert win.calls >= 1 and win.outputs == ["out"] * win.calls
    assert win.elapsed >= 0.2
    # os.times counts in clock ticks of 10 ms
    assert win.cpu_s >= 0.05 * win.calls - 0.02


def test_a_waiting_call_takes_little_cpu_time():
    win = window.run(lambda: window.time.sleep(0.05), 0.2, log=lambda msg: None)
    assert win.cpu_s < 0.25 * win.elapsed


def _ctx(calls=4, cpu_s=8.0, busy_s=0.88, bases=2e9):
    return SimpleNamespace(
        window=SimpleNamespace(calls=calls, cpu_s=cpu_s),
        trace=None if busy_s is None else SimpleNamespace(busy_s=busy_s),
        inputs=SimpleNamespace(bases=bases),
    )


def test_the_card_and_host_time_a_call_per_gbp():
    man = Manifest(ROOT)
    device, host = man.metric_reader("device_s_per_gbp"), man.metric_reader("host_cpu_s_per_gbp")
    assert device.read(_ctx()) == 0.88 / 4 / 2
    assert host.read(_ctx()) == 8.0 / 4 / 2


def test_no_reading_without_a_timeline_or_a_call():
    man = Manifest(ROOT)
    device, host = man.metric_reader("device_s_per_gbp"), man.metric_reader("host_cpu_s_per_gbp")
    assert device.read(_ctx(busy_s=None)) is None
    assert device.read(_ctx(busy_s=0.0)) is None  # the CPU path: no device interval
    assert device.read(_ctx(calls=0)) is None and host.read(_ctx(calls=0)) is None
