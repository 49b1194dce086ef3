"""tpudas_torch's batched fleet execution against its solo steps and the
JAX package's stacked steps.

The stacked cascade and FFT steps (mixed and odd channel widths, every
CPU engine, int16 with one shared ``qscale``, carries moved between solo
and stacked steps) must equal the port's solo steps byte for byte, and
the JAX package's stacked steps within 1e-5 of each channel's scale
(same float32 products, another order); their validation errors match
the JAX package's.  Then the ports of the JAX cases for the
``BatchGroupFormer``, the ``BatchStepExecutor`` rendezvous and the
batched ``FleetEngine``: every stream's output files and carry equal a
single-stream control byte for byte, batched equals unbatched, a fault
mid-round parks one member and shrinks its group, and a
``KeyboardInterrupt`` mid-fleet resumes byte-identical.  The port runs
on the CPU (plain PyTorch versions of the kernels).
"""

import hashlib
import os
import threading
from types import SimpleNamespace

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import numpy as np
import pytest
import torch

from tpudas.ops import filter as jfilter
from tpudas.ops import fir as jfir
from tpudas.testing import make_synthetic_spool
from tpudas_torch.fleet import (
    FleetEngine,
    StreamConfig,
    StreamSpec,
    build_runner,
    drive,
)
from tpudas_torch.fleet.batch import BatchGroupFormer, BatchStepExecutor
from tpudas_torch.obs.registry import MetricsRegistry, use_registry
from tpudas_torch.obs.trace import get_spans
from tpudas_torch.ops import filter as tfilter
from tpudas_torch.ops import fir as tfir
from tpudas_torch.proc.stream import CARRY_FILENAME
from tpudas_torch.resilience import FaultPlan, FaultSpec, install_fault_plan

REL_TOL = 1e-5
WIDTHS_ODD = (5, 8, 1, 3, 7)
CPU_ENGINES = ("torch", "fused-torch")
JAX_ENGINE = {"torch": "xla", "fused-torch": "fused-xla"}


def _plans():
    return (tfir.design_cascade(100.0, 10, 0.45, 4),
            jfir.design_cascade(100.0, 10, 0.45, 4))


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    scale = np.abs(ref).max(axis=0)
    err = np.abs(got - ref).max(axis=0)
    assert (err <= REL_TOL * np.maximum(scale, 1e-30)).all(), err / scale


# ---------------------------------------------------------------------------
# ops layer: stacked steps against solo, byte for byte


class TestStackedCascadeOps:
    @pytest.mark.parametrize("engine", CPU_ENGINES)
    def test_mixed_width_multi_round_byte_identity(self, engine):
        """Ragged packing (odd widths, a one-channel member) over three
        carry-fed rounds: every stream's output and carry leaves equal
        its solo step's."""
        plan, _ = _plans()
        rng = np.random.default_rng(7)
        stacked = [tfir.cascade_stream_init(plan, w, "cpu")
                   for w in WIDTHS_ODD]
        solo = list(stacked)
        for _round in range(3):
            blocks = [torch.from_numpy(
                rng.standard_normal((200, w)).astype(np.float32))
                for w in WIDTHS_ODD]
            res = tfir.cascade_decimate_stream_stacked(
                blocks, stacked, plan, engine)
            stacked = [c for _y, c in res]
            for i, b in enumerate(blocks):
                y, solo[i] = tfir.cascade_decimate_stream(
                    b, solo[i], plan, engine)
                assert torch.equal(res[i][0], y), f"member {i} ({engine})"
                assert res[i][0].is_contiguous()
                for a, bb in zip(stacked[i], solo[i]):
                    assert torch.equal(a, bb) and a.is_contiguous()

    @pytest.mark.parametrize("engine", CPU_ENGINES)
    def test_quantized_int16_stacked(self, engine):
        """An int16 wave with one shared qscale is packed as int16 and
        equals each member's solo quantized step."""
        plan, _ = _plans()
        scale = 2.5e-4
        rng = np.random.default_rng(11)
        widths = (4, 7, 1)
        carries = [tfir.cascade_stream_init(plan, w, "cpu") for w in widths]
        solo = list(carries)
        for _round in range(2):
            blocks = [torch.from_numpy(
                rng.integers(-3000, 3000, (200, w)).astype(np.int16))
                for w in widths]
            res = tfir.cascade_decimate_stream_stacked(
                blocks, carries, plan, engine, qscale=scale)
            carries = [c for _y, c in res]
            for i, b in enumerate(blocks):
                y, solo[i] = tfir.cascade_decimate_stream(
                    b, solo[i], plan, engine, qscale=scale)
                assert torch.equal(res[i][0], y)
                for a, bb in zip(carries[i], solo[i]):
                    assert torch.equal(a, bb)

    def test_carry_slice_roundtrip_solo_stacked_solo(self):
        """A stream moves solo -> stacked -> solo (and across the two
        engines); the sliced carries feed the solo step with no drift.
        Numpy carries (a loaded ``.npz``) pack too."""
        plan, _ = _plans()
        widths = (5, 8)
        rng = np.random.default_rng(3)
        rounds = [[rng.standard_normal((200, w)).astype(np.float32)
                   for w in widths] for _ in range(3)]
        ref_c = [tfir.cascade_stream_init(plan, w, "cpu") for w in widths]
        ref_y = [[], []]
        for blocks in rounds:
            for i, b in enumerate(blocks):
                y, ref_c[i] = tfir.cascade_decimate_stream(
                    b, ref_c[i], plan, "torch", device="cpu")
                ref_y[i].append(y)
        c = [tuple(np.zeros((p, w), np.float32)
                   for p in tfir.stream_carry_sizes(plan)) for w in widths]
        got_y = [[], []]
        for i, b in enumerate(rounds[0]):
            y, c[i] = tfir.cascade_decimate_stream(
                b, c[i], plan, "fused-torch", device="cpu")
            got_y[i].append(y)
        res = tfir.cascade_decimate_stream_stacked(
            rounds[1], [tuple(_np(leaf) for leaf in cc) for cc in c], plan,
            "torch", device="cpu")
        c = [cc for _y, cc in res]
        for i, (y, _cc) in enumerate(res):
            got_y[i].append(y)
        for i, b in enumerate(rounds[2]):
            y, c[i] = tfir.cascade_decimate_stream(
                b, c[i], plan, "torch", device="cpu")
            got_y[i].append(y)
        for i in range(len(widths)):
            for a, b in zip(got_y[i], ref_y[i]):
                assert torch.equal(a, b)
            for a, b in zip(c[i], ref_c[i]):
                assert torch.equal(a, b)

    @pytest.mark.parametrize("int16", [False, True], ids=["f32", "int16"])
    @pytest.mark.parametrize("engine", CPU_ENGINES)
    def test_matches_jax_stacked(self, engine, int16):
        """Port stacked vs JAX stacked (``xla`` / ``fused-xla``) on the
        same seeded blocks, two rounds: within 1e-5 per channel."""
        tplan, jplan = _plans()
        rng = np.random.default_rng(21)
        qs = 1e-3 if int16 else None
        tc = [tfir.cascade_stream_init(tplan, w, "cpu") for w in WIDTHS_ODD]
        jc = [jfir.cascade_stream_init(jplan, w) for w in WIDTHS_ODD]
        for _round in range(2):
            if int16:
                blocks = [rng.integers(-2000, 2000, (200, w)).astype(np.int16)
                          for w in WIDTHS_ODD]
            else:
                blocks = [rng.standard_normal((200, w)).astype(np.float32)
                          for w in WIDTHS_ODD]
            tres = tfir.cascade_decimate_stream_stacked(
                [torch.from_numpy(b) for b in blocks], tc, tplan, engine,
                qscale=qs)
            jres = jfir.cascade_decimate_stream_stacked(
                blocks, jc, jplan, JAX_ENGINE[engine], qscale=qs)
            tc = [c for _y, c in tres]
            jc = [c for _y, c in jres]
            for (ty, tcar), (jy, jcar) in zip(tres, jres):
                _assert_rel(ty.numpy(), np.asarray(jy))
                for a, b in zip(tcar, jcar):
                    _assert_rel(a.numpy(), np.asarray(b))

    def test_stacked_validation_matches_jax(self):
        """Each malformed wave raises ValueError with the JAX package's
        message in both packages."""
        tplan, jplan = _plans()
        cases = [
            ("stacked engine", lambda m, p, c4: (
                [np.zeros((200, 4), np.float32)], [c4], "pallas-stream")),
            ("shared T", lambda m, p, c4: (
                [np.zeros((200, 4), np.float32),
                 np.zeros((100, 4), np.float32)], [c4, c4], None)),
            ("carry width", lambda m, p, c4: (
                [np.zeros((200, 5), np.float32)], [c4], None)),
            ("length mismatch", lambda m, p, c4: (
                [np.zeros((200, 4), np.float32)], [c4, c4], None)),
            ("not a multiple", lambda m, p, c4: (
                [np.zeros((205, 4), np.float32)], [c4], None)),
            ("stream_carry_sizes", lambda m, p, c4: (
                [np.zeros((200, 4), np.float32)], [c4[:-1]], None)),
        ]
        for match, make in cases:
            for mod, plan, eng in ((tfir, tplan, "torch"),
                                   (jfir, jplan, "xla")):
                c4 = tuple(np.zeros((p, 4), np.float32)
                           for p in mod.stream_carry_sizes(plan))
                blocks, carries, bad_eng = make(mod, plan, c4)
                kw = {"device": "cpu"} if mod is tfir else {}
                with pytest.raises(ValueError, match=match):
                    mod.cascade_decimate_stream_stacked(
                        blocks, carries, plan, bad_eng or eng, **kw)

    def test_port_only_checks(self):
        """The port packs int16 raw, so it also refuses a wave of mixed
        dtypes, a qscale without int16, and a CUDA engine on CPU
        tensors (no fallback)."""
        plan, _ = _plans()
        c4 = tfir.cascade_stream_init(plan, 4, "cpu")
        f = torch.zeros((200, 4))
        q = torch.zeros((200, 4), dtype=torch.int16)
        with pytest.raises(ValueError, match="one dtype"):
            tfir.cascade_decimate_stream_stacked([f, q], [c4, c4], plan,
                                                 "torch")
        with pytest.raises(ValueError, match="qscale"):
            tfir.cascade_decimate_stream_stacked([f], [c4], plan, "torch",
                                                 qscale=1e-3)
        for eng in ("cuda", "fused-cuda"):
            with pytest.raises(ValueError, match="CUDA"):
                tfir.cascade_decimate_stream_stacked([f, f], [c4, c4], plan,
                                                     eng)
        assert tfir.cascade_decimate_stream_stacked.launches == {}


class TestStackedFFTOps:
    # T + 2 * edge = 2,048 points: the length at which a one-channel
    # column's FFT differs in the last bit from the same column inside a
    # wider transform on the CPU (the reason members transform alone)
    T, EDGE = 1920, 64

    @pytest.mark.parametrize("int16", [False, True], ids=["f32", "int16"])
    def test_mixed_width_multi_round_byte_identity(self, int16):
        widths = (5, 8, 1, 3)
        rng = np.random.default_rng(5)
        qs = 2e-4 if int16 else None
        stacked = [tfilter.fft_stream_init(self.EDGE, w) for w in widths]
        solo = list(stacked)
        for _round in range(3):
            if int16:
                blocks = [torch.from_numpy(rng.integers(
                    -3000, 3000, (self.T, w)).astype(np.int16))
                    for w in widths]
            else:
                blocks = [torch.from_numpy(rng.standard_normal(
                    (self.T, w)).astype(np.float32)) for w in widths]
            res = tfilter.fft_pass_filter_stream_stacked(
                blocks, stacked, 0.01, high=0.45, qscale=qs)
            stacked = [c for _y, c in res]
            for i, b in enumerate(blocks):
                y, solo[i] = tfilter.fft_pass_filter_stream(
                    b, solo[i], 0.01, high=0.45, qscale=qs)
                assert torch.equal(res[i][0], y), f"member {i} diverged"
                assert torch.equal(stacked[i], solo[i])

    def test_matches_jax_stacked(self):
        widths = (5, 8, 1, 3)
        rng = np.random.default_rng(9)
        tc = [tfilter.fft_stream_init(self.EDGE, w) for w in widths]
        jc = [jfilter.fft_stream_init(self.EDGE, w) for w in widths]
        for _round in range(2):
            blocks = [rng.integers(-3000, 3000, (self.T, w)).astype(np.int16)
                      for w in widths]
            tres = tfilter.fft_pass_filter_stream_stacked(
                [torch.from_numpy(b) for b in blocks], tc, 0.01, high=0.45,
                qscale=1e-3)
            jres = jfilter.fft_pass_filter_stream_stacked(
                blocks, jc, 0.01, high=0.45, qscale=1e-3)
            tc = [c for _y, c in tres]
            jc = [c for _y, c in jres]
            for (ty, tcar), (jy, jcar) in zip(tres, jres):
                _assert_rel(ty.numpy(), np.asarray(jy))
                _assert_rel(tcar.numpy(), np.asarray(jcar))

    def test_stacked_validation_matches_jax(self):
        for mod in (tfilter, jfilter):
            c = mod.fft_stream_init(64, 4)
            kw = {"device": "cpu"} if mod is tfilter else {}
            with pytest.raises(ValueError, match="length mismatch"):
                mod.fft_pass_filter_stream_stacked(
                    [np.zeros((512, 4), np.float32)], [c, c], 0.01,
                    high=0.45, **kw)
            with pytest.raises(ValueError, match="does not match"):
                mod.fft_pass_filter_stream_stacked(
                    [np.zeros((512, 5), np.float32)], [c], 0.01, high=0.45,
                    **kw)
            with pytest.raises(ValueError, match="do not match the wave"):
                mod.fft_pass_filter_stream_stacked(
                    [np.zeros((512, 4), np.float32),
                     np.zeros((256, 4), np.float32)], [c, c], 0.01,
                    high=0.45, **kw)


# ---------------------------------------------------------------------------
# the group former


def _fake_runner(**over):
    cfg = SimpleNamespace(
        engine=over.pop("engine", None),
        filter_order=over.pop("filter_order", 4),
        on_gap=over.pop("on_gap", "interpolate"),
    )
    r = SimpleNamespace(
        kind="lowpass", stateful=True, mesh=None,
        spec=SimpleNamespace(config=cfg), d_t=1.0, buff_out=8,
        process_patch_size=40, carry=None,
    )
    for k, v in over.items():
        setattr(r, k, v)
    return r


class TestBatchGroupFormer:
    def test_group_key_determinism(self):
        f = BatchGroupFormer()
        a = f.signature("a", _fake_runner())
        b = f.signature("b", _fake_runner())
        assert a is not None and a == b
        assert f.signature("c", _fake_runner(engine="fused")) != a
        assert f.signature("d", _fake_runner(filter_order=6)) != a
        assert f.signature("e", _fake_runner(d_t=2.0)) != a
        assert f.signature("a", _fake_runner()) == a

    def test_solo_only_streams_get_none(self):
        f = BatchGroupFormer()
        assert f.signature("a", None) is None
        assert f.signature("b", _fake_runner(kind="rolling")) is None
        assert f.signature("c", _fake_runner(stateful=False)) is None
        assert f.signature("d", _fake_runner(mesh=object())) is None

    def test_memo_hit_miss_and_invalidate(self):
        reg = MetricsRegistry()
        f = BatchGroupFormer()
        r = _fake_runner()
        with use_registry(reg):
            f.signature("a", r)
            f.signature("a", r)  # same runner, same token -> hit
            f.invalidate("a")
            f.signature("a", r)  # invalidated -> recompute
        assert reg.value("tpudas_fleet_batch_sig_memo_total",
                         result="hit") == 1
        assert reg.value("tpudas_fleet_batch_sig_memo_total",
                         result="miss") == 2

    def test_carry_change_invalidates_token(self):
        """An engine crossover mutates the carry's engine fields; the
        memo token sees it and recomputes."""
        reg = MetricsRegistry()
        f = BatchGroupFormer()
        carry = SimpleNamespace(
            kind="cascade", engine_req="auto", d_ns=10_000_000,
            ratio=100, edge_in=800, order=4,
        )
        r = _fake_runner(carry=carry)
        with use_registry(reg):
            s1 = f.signature("a", r)
            carry.engine_req = "fused"
            s2 = f.signature("a", r)
        assert s1 != s2
        assert reg.value("tpudas_fleet_batch_sig_memo_total",
                         result="miss") == 2


# ---------------------------------------------------------------------------
# the rendezvous executor


def _run_members(ex, fns):
    """One callable per member on its own thread (bind/leave contract
    included) -> {member: result or exception}."""
    out = {}

    def runner(m, fn):
        ex.bind(m)
        try:
            out[m] = fn()
        except BaseException as exc:  # noqa: BLE001
            out[m] = exc
        finally:
            ex.leave(m)

    threads = [threading.Thread(target=runner, args=(m, fn))
               for m, fn in fns.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    return out


def _block(rng, t, w):
    return torch.from_numpy(rng.standard_normal((t, w)).astype(np.float32))


class TestBatchStepExecutor:
    @pytest.mark.parametrize("engine", CPU_ENGINES)
    def test_same_key_wave_stacks_and_matches_solo(self, engine):
        plan, _ = _plans()
        rng = np.random.default_rng(2)
        widths = {"a": 5, "b": 8, "c": 3}
        blocks = {m: _block(rng, 200, w) for m, w in widths.items()}
        reg = MetricsRegistry()
        ex = BatchStepExecutor(widths)
        with use_registry(reg):
            res = _run_members(ex, {
                m: (lambda m=m: ex.cascade_step(
                    blocks[m], tfir.cascade_stream_init(plan, widths[m],
                                                        "cpu"),
                    plan, engine))
                for m in widths
            })
        assert reg.value("tpudas_fleet_batch_stacked_launches_total") == 1
        assert reg.value("tpudas_fleet_batch_stacked_members_total") == 3
        assert any(s["attrs"].get("streams") == 3
                   for s in get_spans("op.stacked"))
        for m, w in widths.items():
            y, _carry = res[m]
            y_solo, _ = tfir.cascade_decimate_stream(
                blocks[m], tfir.cascade_stream_init(plan, w, "cpu"), plan,
                engine)
            assert torch.equal(y, y_solo)

    def test_mixed_keys_partition_into_waves(self):
        """Members whose exact stack key differs (block length, resolved
        engine) split into a stacked pair plus solo dispatches."""
        plan, _ = _plans()
        rng = np.random.default_rng(4)
        reg = MetricsRegistry()
        ex = BatchStepExecutor(["a", "b", "c", "d"])

        def step(t, w, eng="torch"):
            return lambda: ex.cascade_step(
                _block(rng, t, w), tfir.cascade_stream_init(plan, w, "cpu"),
                plan, eng)

        with use_registry(reg):
            res = _run_members(ex, {
                "a": step(200, 5), "b": step(200, 8), "c": step(400, 5),
                "d": step(200, 5, "fused-torch"),
            })
        assert reg.value("tpudas_fleet_batch_stacked_launches_total") == 1
        assert reg.value("tpudas_fleet_batch_solo_launches_total") == 2
        assert tuple(res["c"][0].shape) == (40, 5)

    def test_fft_wave_stacks(self):
        """Co-parameter FFT steps meet at the rendezvous as one wave, and
        each member transforms at its own width: no stacked launch."""
        rng = np.random.default_rng(8)
        widths = {"a": 4, "b": 1}
        blocks = {m: _block(rng, 512, w) for m, w in widths.items()}
        reg = MetricsRegistry()
        ex = BatchStepExecutor(widths)
        with use_registry(reg):
            res = _run_members(ex, {
                m: (lambda m=m: ex.fft_step(
                    blocks[m], tfilter.fft_stream_init(64, widths[m]), 0.01,
                    0.45, 4))
                for m in widths
            })
        assert reg.value("tpudas_fleet_batch_stacked_launches_total") == 0
        assert reg.value("tpudas_fleet_batch_solo_launches_total") == 2
        for m, w in widths.items():
            y, c = tfilter.fft_pass_filter_stream(
                blocks[m], tfilter.fft_stream_init(64, w), 0.01, high=0.45)
            assert torch.equal(res[m][0], y) and torch.equal(res[m][1], c)

    def test_leave_shrinks_rendezvous(self):
        """A member that leaves without submitting (a fault before its
        device step) must not deadlock the others."""
        plan, _ = _plans()
        rng = np.random.default_rng(6)
        ex = BatchStepExecutor(["a", "b", "c"])

        def faulty():
            raise ValueError("pre-dispatch fault")

        res = _run_members(ex, {
            "a": lambda: ex.cascade_step(
                _block(rng, 200, 5), tfir.cascade_stream_init(plan, 5, "cpu"),
                plan, "torch"),
            "b": lambda: ex.cascade_step(
                _block(rng, 200, 5), tfir.cascade_stream_init(plan, 5, "cpu"),
                plan, "torch"),
            "c": faulty,
        })
        assert isinstance(res["c"], ValueError)
        for m in ("a", "b"):
            y, carry = res[m]
            assert tuple(y.shape) == (20, 5)
            assert len(carry) > 0

    def test_wave_error_reaches_every_member(self):
        """A step that raises inside a stacked wave raises in each of
        its members' threads (no member waits forever)."""
        plan, _ = _plans()
        ex = BatchStepExecutor(["a", "b"])
        bad = tuple(torch.zeros((1, 3)) for _ in tfir.stream_carry_sizes(plan))
        res = _run_members(ex, {
            m: (lambda: ex.cascade_step(torch.zeros((200, 3)), bad, plan,
                                        "torch"))
            for m in ("a", "b")
        })
        assert all(isinstance(res[m], ValueError) for m in ("a", "b"))


# ---------------------------------------------------------------------------
# the batched fleet, end to end

FS = 100.0
FILE_SEC = 30.0
T0 = "2023-03-22T00:00:00"
WIDTHS = {"s0": 6, "s1": 9, "s2": 5}
NOISES = {"s0": 0.005, "s1": 0.01, "s2": 0.02}


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    """Three contiguous files per stream (its own width and noise)."""
    out = {}
    for sid, w in WIDTHS.items():
        d = tmp_path_factory.mktemp(f"pool-{sid}")
        make_synthetic_spool(d, n_files=3, file_duration=FILE_SEC, fs=FS,
                             n_ch=w, noise=NOISES[sid])
        out[sid] = str(d)
    return out


def _link(pool, src, upto):
    os.makedirs(src, exist_ok=True)
    names = sorted(n for n in os.listdir(pool) if n.endswith(".h5"))
    for name in names[:upto]:
        if not os.path.exists(os.path.join(src, name)):
            os.link(os.path.join(pool, name), os.path.join(src, name))


def _config(**over):
    base = dict(kind="lowpass", start_time=T0, output_sample_interval=1.0,
                edge_buffer=8.0, process_patch_size=40, poll_interval=0.0,
                poll_jitter=0.0)
    base.update(over)
    return StreamConfig(**base)


def _specs(pools, tmp_path, first=2, **over):
    specs = []
    for sid in WIDTHS:
        src = str(tmp_path / f"src_{sid}")
        _link(pools[sid], src, first)
        specs.append(StreamSpec(stream_id=sid, source=src,
                                config=_config(**over)))
    return specs


def _shas(folder) -> dict:
    """{name: sha256} of the output files and the carry."""
    out = {}
    for name in sorted(os.listdir(folder)):
        if name.startswith("LFDAS_") or name == CARRY_FILENAME:
            with open(os.path.join(folder, name), "rb") as fh:
                out[name] = hashlib.sha256(fh.read()).hexdigest()
    return out


def _control(pools, tmp_path, sid, first=2, then=(), **over):
    """The stream alone: ``drive(build_runner(...))`` over the same feed."""
    src = str(tmp_path / f"ctrl_src_{sid}")
    _link(pools[sid], src, first)
    feeds = list(then)

    def sleep(_):
        if feeds:
            _link(pools[sid], src, feeds.pop(0))

    spec = StreamSpec(stream_id=sid, source=src, config=_config(**over))
    root = str(tmp_path / "ctrl")
    drive(build_runner(spec, root=root, device="cpu"), sleep_fn=sleep)
    return os.path.join(root, sid)


def _assert_match_controls(pools, tmp_path, root, sids=None, **kw):
    for sid in sids or WIDTHS:
        got = _shas(os.path.join(root, sid))
        assert CARRY_FILENAME in got and len(got) > 1
        want = _shas(_control(pools, tmp_path / f"c_{sid}", sid, **kw))
        assert got == want, f"stream {sid} differs from its solo control"


class TestFleetBatched:
    @pytest.mark.parametrize("engine", ["auto", "fused", "fft"])
    def test_mixed_width_byte_identity_and_metrics(self, pools, tmp_path,
                                                   engine, monkeypatch):
        """Three mixed-width streams through the batched scheduler: every
        cascade step stacks (ragged packing) and every FFT step runs at
        its member's width; outputs and carries equal the per-stream
        controls, and equal an unbatched fleet's."""
        monkeypatch.setenv("TPUDAS_FUSED_MIN_ELEMS", "0")
        root = str(tmp_path / "root")
        specs = _specs(pools, tmp_path, engine=engine)
        fed = {"done": False}

        def fleet_sleep(_):
            if not fed["done"]:
                fed["done"] = True
                for sid in WIDTHS:
                    _link(pools[sid], str(tmp_path / f"src_{sid}"), 3)

        reg = MetricsRegistry()
        with use_registry(reg):
            summary = FleetEngine(root, specs, sleep_fn=fleet_sleep,
                                  batched=True, device="cpu").run()
        assert summary["rounds_total"] == 6
        assert summary["parked"] == []
        # zero jitter: every poll (2 processing rounds + the final
        # termination poll) services as one 3-member group
        assert reg.value("tpudas_fleet_batch_groups_total") == 3
        assert reg.value("tpudas_fleet_batch_members_total") == 9
        launches = reg.value("tpudas_fleet_batch_stacked_launches_total")
        solo = reg.value("tpudas_fleet_batch_solo_launches_total")
        if engine == "fft":
            assert launches == 0 and solo > 0 and solo % 3 == 0
        else:
            assert launches > 0 and solo == 0
        assert reg.value("tpudas_fleet_batch_stacked_members_total") == (
            3 * launches)
        _assert_match_controls(pools, tmp_path, root, then=[3],
                               engine=engine)
        # the same fleet unbatched: the same bytes
        root2 = str(tmp_path / "root_unbatched")
        specs2 = _specs(pools, tmp_path / "u", first=3, engine=engine)
        FleetEngine(root2, specs2, sleep_fn=lambda _s: None, batched=False,
                    device="cpu").run()
        root3 = str(tmp_path / "root_batched3")
        specs3 = _specs(pools, tmp_path / "b", first=3, engine=engine)
        FleetEngine(root3, specs3, sleep_fn=lambda _s: None, batched=True,
                    device="cpu").run()
        for sid in WIDTHS:
            assert _shas(os.path.join(root2, sid)) == _shas(
                os.path.join(root3, sid))

    def test_env_var_enables_batching(self, pools, tmp_path, monkeypatch):
        specs = _specs(pools, tmp_path)
        monkeypatch.setenv("TPUDAS_FLEET_BATCHED", "1")
        root = str(tmp_path / "root")
        assert FleetEngine(root, specs, sleep_fn=lambda _s: None,
                           device="cpu").batched is True
        monkeypatch.setenv("TPUDAS_FLEET_BATCHED", "0")
        assert FleetEngine(root, specs, sleep_fn=lambda _s: None,
                           device="cpu").batched is False

    def test_fault_mid_round_shrinks_batch_not_fleet(self, pools, tmp_path):
        """A member faulting mid-round (its carry save) drops out of its
        group and parks; the others stay byte-identical to their solo
        controls, and a fresh engine finishes the parked one."""
        root = str(tmp_path / "root")
        specs = _specs(pools, tmp_path)
        plan = FaultPlan(FaultSpec("carry.save", exc=ValueError, at=1,
                                   times=50, match=os.sep + "s1"))
        reg = MetricsRegistry()
        with use_registry(reg), install_fault_plan(plan):
            summary = FleetEngine(root, specs, sleep_fn=lambda _s: None,
                                  batched=True, device="cpu").run()
        assert summary["streams"]["s1"]["status"] == "parked"
        for sid in ("s0", "s2"):
            assert summary["streams"][sid]["status"] == "terminated"
        assert reg.value("tpudas_fleet_batch_groups_total") >= 1
        _assert_match_controls(pools, tmp_path, root, sids=("s0", "s2"))
        summary2 = FleetEngine(root, specs, sleep_fn=lambda _s: None,
                               batched=True, device="cpu").run()
        assert summary2["streams"]["s1"]["status"] == "terminated"
        _assert_match_controls(pools, tmp_path, root, sids=("s1",))

    def test_ki_mid_batched_fleet_resumes_byte_identical(self, pools,
                                                         tmp_path):
        """KeyboardInterrupt mid-round under batched execution kills the
        engine; a fresh batched engine resumes every stream
        byte-identical to its uninterrupted solo control."""
        root = str(tmp_path / "root")
        specs = _specs(pools, tmp_path)
        plan = FaultPlan(FaultSpec("round.body", exc=KeyboardInterrupt,
                                   at=2))
        with install_fault_plan(plan):
            with pytest.raises(KeyboardInterrupt):
                FleetEngine(root, specs, sleep_fn=lambda _s: None,
                            batched=True, device="cpu").run()
        summary = FleetEngine(root, specs, sleep_fn=lambda _s: None,
                              batched=True, device="cpu").run()
        assert summary["parked"] == []
        _assert_match_controls(pools, tmp_path, root)
