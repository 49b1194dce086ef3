"""The reduction of a traced window: device busy time as the union of
its kernels and copies, kernel time by short name, and each idle gap
charged to the innermost harness span open at its middle."""

import pytest

from portbench.harness.trace import kernel_seconds, short_name, summarize_events


@pytest.mark.parametrize("raw,short", [
    ("void (anonymous namespace)::v2::fir_v2_kernel<short, 16, 8, 6>"
     "(short const*, float const*, float*, long long, int)",
     "v2::fir_v2_kernel"),
    ("void (anonymous namespace)::stage01_kernel<short>(short const*, "
     "float*, (anonymous namespace)::Stage01Params)", "stage01_kernel"),
    ("regular_fft_factor", "regular_fft_factor"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "FillFunctor<float>, std::array<char*, 1ul> >(int, T, A)",
     "at::native::vectorized_elementwise_kernel"),
])
def test_short_name(raw, short):
    assert short_name(raw) == short


def test_busy_union_kernels_and_gap_labels():
    ms = 1_000_000
    events = [
        ("pb.window", "user_annotation", 0, 100 * ms),
        ("pb.pass", "user_annotation", 0, 100 * ms),
        ("void (anonymous namespace)::stage01_kernel<short>(short const*)",
         "kernel", 10 * ms, 20 * ms),
        ("fused_cascade_kernel", "kernel", 15 * ms, 30 * ms),
        ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 60 * ms, 70 * ms),
        ("aten::copy_", "cpu_op", 0, 5 * ms),
    ]
    host = [("pb.load_window", 30 * ms, 60 * ms),
            ("pb.write_output", 70 * ms, 100 * ms)]
    s = summarize_events(events, host)
    assert s["window_s"] == pytest.approx(0.1)
    assert s["busy_s"] == pytest.approx(0.03)
    assert kernel_seconds(s, "stage01_kernel") == pytest.approx(0.01)
    assert kernel_seconds(s) == pytest.approx(0.025)
    assert dict(s["idle_gaps"]) == pytest.approx(
        {"pb.pass": 0.01, "pb.load_window": 0.03, "pb.write_output": 0.03})
    assert s["device_ops"][0] == ["fused_cascade_kernel", pytest.approx(0.015)]


def test_the_card_alone_is_traced_where_asked():
    from portbench.harness.trace import traced

    with traced(True, "cpu", host=False) as tr:
        pass
    assert tr.prof is None  # no card: nothing to record
    assert summarize_events([])["busy_s"] == 0.0


def test_a_pass_reads_its_card_time_from_the_device_events_alone():
    from portbench.harness.cell import load_reader

    ms = 1_000_000
    events = [  # no pb.window range: the card's work alone was recorded
        ("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 10 * ms, 40 * ms),
        ("void (anonymous namespace)::v2::fir_v2_kernel<short>(short*)",
         "kernel", 35 * ms, 45 * ms),
        ("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 70 * ms, 90 * ms),
        ("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 95 * ms,
         100 * ms),
    ]
    s = summarize_events(events)
    assert s["busy_s"] == pytest.approx(0.06)
    assert s["copies"]["Memcpy HtoD (Pinned -> Device)"] == pytest.approx(
        0.05)
    ctx = {"trace": s, "jobs": 2}
    assert load_reader("pass_card_ms").read(ctx) == pytest.approx(30.0)
    assert load_reader("pass_h2d_ms").read(ctx) == pytest.approx(25.0)
    assert load_reader("pass_card_ms").read(dict(ctx, trace=None)) is None
    assert load_reader("pass_card_ms").read(
        {"trace": summarize_events([]), "jobs": 2}) is None
