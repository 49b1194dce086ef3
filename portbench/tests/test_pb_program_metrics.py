"""The per-layer metrics read from the program's own spans and counters,
rehearsed on the CPU at a small width: each returns a finite number in
the traced run of its cells, and agrees with what the harness measures
of the same layer from outside."""

import math

import pytest

from portbench import run as pb_run
from portbench.harness import cell as cell_mod

SMALL = {"n_ch": 16}
SEED = 2**31 + 29
PROGRAM_METRICS = ("read_GBps", "pass_host_ms", "write_ms", "round_h2d_ms",
                   "round_pool_ms", "restart_ms", "round_fetch_ms",
                   "round_emit_ms", "carry_save_ms")


def _cells():
    out = []
    for workload in ("edge10k.archive", "edge10k-fft.archive",
                     "edge10k.catchup", "edge10k-fft.catchup"):
        names = {m["name"] for m in cell_mod.resolve(workload)["per_layer"]}
        out.append((workload, sorted(names & set(PROGRAM_METRICS))))
    return out


BRACKET = ("read_GBps", "host_read_GBps")


def _with_the_read_metrics(resolve):
    """``resolve`` with the read's two metrics in every archive cell's
    per-layer list: the B1 archive cell reports them no more (its
    rate is not bounded there), and its pass reads as the FFT one's."""
    def wrapped(workload, *args, **kwargs):
        cell = resolve(workload, *args, **kwargs)
        if cell["traffic"]["driver"] == "archive":
            entries = resolve("edge10k-fft.archive")["per_layer"]
            have = {m["name"] for m in cell["per_layer"]}
            cell["per_layer"] += [m for m in entries
                                  if m["name"] in BRACKET
                                  and m["name"] not in have]
        return cell
    return wrapped


@pytest.fixture(scope="module")
def traced():
    """Each cell's traced rehearsal, run once."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cell_mod, "resolve", _with_the_read_metrics(
            cell_mod.resolve))
        return {w: pb_run.run_cell(w, SEED, 0.5, 1, device="cpu",
                                   config_overrides=SMALL)[0]
                for w, _names in _cells()}


def test_every_program_metric_is_in_a_cell():
    listed = {n for _w, names in _cells() for n in names}
    assert listed == set(PROGRAM_METRICS)


@pytest.mark.parametrize("workload,names", _cells())
def test_each_reader_returns_a_finite_value(traced, workload, names):
    result = traced[workload]
    assert result["correct"]
    for name in names:
        value = result["metrics"][name]["value"]
        assert math.isfinite(value) and value > 0, (name, value)


@pytest.mark.parametrize("workload", ["edge10k.archive",
                                      "edge10k-fft.archive"])
def test_the_read_span_lies_inside_the_harness_bracket(traced, workload):
    m = traced[workload]["metrics"]
    assert m["read_GBps"]["value"] >= m["host_read_GBps"]["value"]


@pytest.mark.parametrize("workload", ["edge10k.catchup",
                                      "edge10k-fft.catchup"])
def test_the_round_spans_lie_inside_host_wait(traced, workload):
    m = traced[workload]["metrics"]
    inside = sum(m[name]["value"] for name in (
        "round_h2d_ms", "round_pool_ms", "round_fetch_ms", "round_emit_ms"))
    assert inside <= m["host_wait_ms"]["value"]


def test_the_readers_find_nothing_without_the_programs_spans():
    """A program without these spans and counters (the parent of the
    change that added them) leaves each metric out, not raising."""
    from tpudas_torch.obs.registry import MetricsRegistry

    ctx = {"registry": MetricsRegistry()}
    for name in PROGRAM_METRICS:
        assert cell_mod.load_reader(name).read(ctx) is None
