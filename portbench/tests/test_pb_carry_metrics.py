"""The carry commit's two per-layer readers: ``carry_write_ms`` (the
``stream.carry_write`` spans a round) and ``carry_staged_share`` (the
carry bytes staged from the card through page-locked memory, over all
the carry bytes saved).  Each reads the expected number from known
spans and counters, finds nothing where its denominator is zero, and
returns a value in the traced CPU rehearsal of the catch-up cells."""

import math

import pytest

from portbench import run as pb_run
from portbench.harness import cell as cell_mod
from tpudas_torch.obs.registry import MetricsRegistry

STAGED = "tpudas_stream_carry_staged_bytes_total"
SMALL = {"n_ch": 16}
SEED = 2**31 + 53


def _reader(name):
    return cell_mod.load_reader(name)


def _spans(write_s, rounds):
    """A registry holding ``stream.carry_write`` spans of ``write_s``
    seconds and ``rounds`` rounds' ``host_wait`` phase."""
    reg = MetricsRegistry()
    spans = reg.histogram("tpudas_span_seconds", labelnames=("name",))
    for s in write_s:
        spans.observe(s, name="stream.carry_write")
    spans.observe(9.0, name="stream.carry_save")  # another span: unread
    phases = reg.histogram("tpudas_stream_round_phase_seconds",
                           labelnames=("phase",))
    for _ in range(rounds):
        phases.observe(1.0, phase="host_wait")
    return {"registry": reg}


def test_carry_write_ms_is_the_span_sum_a_round():
    ctx = _spans([0.25, 0.5, 0.75], rounds=2)
    assert _reader("carry_write_ms").read(ctx) == pytest.approx(750.0)


@pytest.mark.parametrize("write_s,rounds", [([0.5], 0), ([], 3)],
                         ids=["no_rounds", "no_spans"])
def test_carry_write_ms_finds_nothing_without_a_denominator(write_s,
                                                            rounds):
    assert _reader("carry_write_ms").read(_spans(write_s, rounds)) is None


@pytest.mark.parametrize("pinned,direct,share", [
    (800_000_000, 40_000, 100.0 * 800_000_000 / 800_040_000),
    (34_000_000, 0, 100.0),
    (0, 40_000, 0.0),
])
def test_carry_staged_share_is_pinned_over_all(pinned, direct, share):
    reg = MetricsRegistry()
    counter = reg.counter(STAGED, labelnames=("path",))
    counter.inc(pinned, path="pinned")
    counter.inc(direct, path="direct")
    got = _reader("carry_staged_share").read({"registry": reg})
    assert got == pytest.approx(share)


def test_carry_staged_share_finds_nothing_without_saves():
    reg = MetricsRegistry()
    assert _reader("carry_staged_share").read({"registry": reg}) is None
    reg.counter(STAGED, labelnames=("path",))  # registered, never counted
    assert _reader("carry_staged_share").read({"registry": reg}) is None


@pytest.mark.parametrize("workload", ["edge10k.catchup",
                                      "edge10k-fft.catchup"])
def test_the_readers_report_in_the_traced_rehearsal(workload):
    """On the CPU every carry leaf is a host tensor, so the share reads
    0; the write is a part of the save."""
    names = {m["name"] for m in cell_mod.resolve(workload)["per_layer"]}
    assert {"carry_write_ms", "carry_staged_share"} <= names
    result, checks = pb_run.run_cell(workload, SEED, 0.5, 1, device="cpu",
                                     config_overrides=SMALL)
    assert result["correct"], checks
    m = result["metrics"]
    write = m["carry_write_ms"]["value"]
    assert math.isfinite(write) and 0 < write < m["carry_save_ms"]["value"]
    assert m["carry_staged_share"]["value"] == 0.0
