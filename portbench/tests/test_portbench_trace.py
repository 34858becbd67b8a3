"""The device summary on a hand-made timeline: busy time is the union
of device activity inside the window, idle time goes to the innermost
program span open at each instant."""

import pytest
from repro_torch.obs.trace import Span

from portbench.trace import Capture, KernelCalls, device_summary


def _capture(events, spans, t0=0.0, t1=10.0):
    cap = Capture(KernelCalls(), "cuda")
    cap.events, cap.spans, cap.t0, cap.t1 = events, spans, t0, t1
    return cap


def test_busy_by_name_and_idle_by_innermost_span():
    events = [(-1.0, 1.0, "k2"), (0.5, 2.0, "k1"),   # overlap, clipped at 0
              (4.0, 5.0, "k2"), (9.5, 11.0, "k1")]   # clipped at 10
    spans = [Span("tick", t0=2.5, dur=6.0, depth=0),
             Span("window", t0=3.0, dur=0.5, depth=1),
             Span("refine", t0=6.0, dur=2.0, depth=1)]
    out = device_summary(_capture(events, spans))
    assert out["busy_s"] == pytest.approx(2.0 + 1.0 + 0.5)
    assert out["window_s"] == 10.0
    assert dict(out["device_ops"]) == pytest.approx({"k2": 2.0, "k1": 2.0})
    # idle: [2, 4] and [5, 9.5]
    idle = dict(out["idle_gaps"])
    assert idle == pytest.approx({
        "tick": 0.5 + 0.5 + 1.0 + 0.5,        # 2.5-3, 3.5-4, 5-6, 8-8.5
        "window": 0.5, "refine": 2.0,
        "(no program span)": 0.5 + 1.0})      # 2-2.5, 8.5-9.5


def test_no_summary_off_the_card():
    cap = Capture(KernelCalls(), "cpu")
    assert device_summary(cap) is None


def test_roofline_reader_counts_the_calls_work_over_the_kernels_time():
    from types import SimpleNamespace

    from portbench import readers, roofline
    calls = KernelCalls()
    calls.k2 = [(4, 2097152, ("grid",) * 4)] * 10
    ctx = SimpleNamespace(
        kernel_calls=calls,
        structures={"grid": {"n": 4096, "edges": 11520, "k": 6}},
        device={"by_name": {
            "void viem::(anonymous namespace)::pair_gains<0, 3, 4>(int)":
                2e-3,
            "void at::native::reduce_kernel<512>(int)": 1.0}})
    least = roofline.least_seconds(*roofline.k2_work(4, 2097152, 6, 4096))[0]
    assert readers.kernel_roofline_pct(ctx, "k2") == pytest.approx(
        100 * 10 * least / 2e-3)
    assert readers.kernel_roofline_pct(ctx, "k1") is None   # no call
    # four lanes of one structure read its pair ids once: about half the
    # bytes of four lanes each with pairs of its own
    four = readers.call_work("k2", calls.k2[0], ctx.structures)[0]
    assert four == roofline.k2_work(4, 2097152, 6, 4096)[0]
    assert four == pytest.approx(
        2 * 2097152 * 4 + 4096 * 6 * 4
        + 4 * (4096 * 6 * 4 + 4096 * 4 + 2097152 * 4))
    # lanes of two structures: each structure's ids once
    ctx.structures["rgg"] = {"n": 4096, "edges": 11949, "k": 15}
    mixed = readers.call_work("k2", (4, 2097152, ("grid", "rgg") * 2),
                              ctx.structures)[0]
    assert mixed == roofline.k2_work(2, 2097152, 6, 4096)[0] + \
        roofline.k2_work(2, 2097152, 15, 4096)[0]
    # a lane of no known structure: no count
    assert readers.call_work("k2", (1, 8, (None,)), ctx.structures) is None


def test_kernel_calls_take_the_structures_of_the_plan_entry():
    calls = KernelCalls()
    assert calls.lanes_of(2) == (None, None)
    calls._entry = ("a", "b", "a")
    assert calls.lanes_of(3) == ("a", "b", "a")
    assert calls.lanes_of(4) == ("a", "b", "a", "a")
