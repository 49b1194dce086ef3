"""tpudas_torch.parallel against the single-device port and tpudas.parallel.

The cases of ``tests/test_parallel.py`` on the port's process-local
mesh: ``make_mesh(..., device="cpu")`` builds N logical CPU shards, on
which every shard runs the plain PyTorch versions of the kernels, while
the JAX side runs on the 8 virtual host devices of ``conftest.py``.

Within the port the rule is byte equality: channel-sharded and
single-device, time-sharded and single-device, window-DP and serial
give the same bytes (outputs and carries).  Against the JAX package the
rule is 1e-5 of each channel's scale, always against the JAX
*single-device* result (its own window-DP and time-sharded outputs
differ from its serial run in the last bits).  Layout math
(``channel_pad``, ``fir_halo_rows``, ``sharded_cascade_layout``) must
equal the JAX package's exactly.
"""

import numpy as np
import pytest
import torch

import jax
from tpudas.ops import filter as jfilter
from tpudas.ops import fir as jfir
from tpudas.parallel import mesh as jmesh
from tpudas_torch.ops import filter as tfilter
from tpudas_torch.ops import fir
from tpudas_torch.ops._build import KernelError
from tpudas_torch.parallel import halo, pipeline, sharding
from tpudas_torch.parallel.batch import (
    batched_cascade_decimate,
    batched_rolling_mean,
)
from tpudas_torch.parallel.mesh import (
    DeviceMesh,
    device_count,
    make_mesh,
    resolve_mesh,
)

REL_TOL = 1e-5
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def require_8_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")


def _signal(T, C, fs, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(T) / fs
    lf = np.sin(2 * np.pi * 0.05 * t)[:, None] * (1 + np.arange(C))[None, :]
    return (lf + 0.3 * rng.standard_normal((T, C))).astype(np.float32)


def _plans(fs=100.0, ratio=20):
    """The same design in both packages (taps bit-equal)."""
    return (fir.design_cascade(fs, ratio, 0.45, 4),
            jfir.design_cascade(fs, ratio, 0.45, 4))


def _assert_close(got, ref, tol=REL_TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = np.abs(ref).max(axis=0)
    floor = max(float(scale.max()) * 1e-7, 1e-30)
    err = np.abs(got - ref).max(axis=0)
    assert (err <= tol * np.maximum(scale, floor)).all(), float(err.max())


def _equal(a, b):
    return np.array_equal(np.asarray(a), np.asarray(b))


class TestMesh:
    def test_make_mesh_shapes(self):
        for n, ts in ((8, 2), (8, 1), (4, 4), (2, 1)):
            m = make_mesh(n, time_shards=ts, device=CPU)
            assert m.shape == dict(jmesh.make_mesh(n, time_shards=ts).shape)
            assert m.size == n and m.device_type == "cpu"
        assert make_mesh(device=CPU).shape == {"time": 1, "ch": 8}

    def test_bad_factorization(self):
        with pytest.raises(ValueError, match="must divide"):
            make_mesh(8, time_shards=3, device=CPU)
        with pytest.raises(ValueError, match="must divide"):
            jmesh.make_mesh(8, time_shards=3)

    def test_explicit_grid(self):
        """A grid may repeat one device (the one-card layout): shards
        then run in order on it; mixed device types are refused."""
        m = DeviceMesh([torch.device("cpu")] * 3)
        assert m.shape == {"time": 1, "ch": 3}
        assert m.unique_devices() == [torch.device("cpu")]
        assert m.axis_devices("ch") == [torch.device("cpu")] * 3
        m2 = DeviceMesh([["cpu", "cpu"], ["cpu", "cpu"]])
        assert m2.shape == {"time": 2, "ch": 2}
        assert DeviceMesh(["cpu"] * 4, axis_names=("win",)).shape == {"win": 4}
        with pytest.raises(ValueError, match="one device type"):
            DeviceMesh(["cpu", "meta"])


class TestResolveMesh:
    def test_int_env_and_passthrough(self, monkeypatch):
        monkeypatch.delenv("TPUDAS_MESH", raising=False)
        for pkg_resolve, kw in ((resolve_mesh, {"device": CPU}),
                                (jmesh.resolve_mesh, {})):
            assert pkg_resolve(None, **kw) is None
            assert pkg_resolve(0, **kw) is None
            assert pkg_resolve(1, **kw) is None
            m = pkg_resolve(4, **kw)
            assert dict(m.shape) == {"time": 1, "ch": 4}
            assert pkg_resolve(m, **kw) is m
        monkeypatch.setenv("TPUDAS_MESH", "2")
        assert resolve_mesh(None, device=CPU).shape == {"time": 1, "ch": 2}
        assert dict(jmesh.resolve_mesh(None).shape) == {"time": 1, "ch": 2}
        # an explicit argument wins over the environment
        assert resolve_mesh(0, device=CPU) is None

    def test_bad_counts_rejected(self, monkeypatch):
        for pkg_resolve, kw, n in ((resolve_mesh, {"device": CPU},
                                    device_count(CPU)),
                                   (jmesh.resolve_mesh, {},
                                    len(jax.devices()))):
            with pytest.raises(ValueError, match=">= 0"):
                pkg_resolve(-1, **kw)
            with pytest.raises(ValueError,
                               match=f"exceeds the {n} available"):
                pkg_resolve(n + 1, **kw)
        # the cards: none on this host, so any mesh over them exceeds
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(ValueError, match="exceeds the 0 available"):
            resolve_mesh(2)

    def test_shard_gauge_follows_resolution(self):
        from tpudas.obs.registry import MetricsRegistry as JReg
        from tpudas.obs.registry import use_registry as juse
        from tpudas_torch.obs.registry import MetricsRegistry, use_registry

        for reg, use, fn, kw in ((MetricsRegistry(), use_registry,
                                  resolve_mesh, {"device": CPU}),
                                 (JReg(), juse, jmesh.resolve_mesh, {})):
            with use(reg):
                fn(4, **kw)
            assert reg.get("tpudas_parallel_shards").value() == 4
            with use(reg):
                fn(None, **kw)
            assert reg.get("tpudas_parallel_shards").value() == 1


class TestChannelSharding:
    def test_zero_comm_filter_matches_single_device(self):
        fs = 100.0
        data = _signal(3000, 16, fs)
        ref = tfilter.fft_pass_filter(data, 1 / fs, high=2.0, device=CPU)
        mesh = make_mesh(8, device=CPU)
        shards = sharding.shard_channels(data, mesh)
        assert len(shards) == 8 and shards.shape == (3000, 16)
        out = sharding.gather_columns(
            [tfilter.fft_pass_filter(s, 1 / fs, high=2.0) for s in shards])
        assert torch.equal(out, ref)
        _assert_close(out, jfilter.fft_pass_filter(data, 1 / fs, high=2.0))

    def test_layout_descriptor(self):
        mesh = make_mesh(8, time_shards=2, device=CPU)
        layout = sharding.channel_sharding(mesh)
        assert layout.spec == (None, "ch") and len(layout.devices) == 4
        with pytest.raises(ValueError, match="split evenly"):
            sharding.shard_channels(np.zeros((2, 6), np.float32), mesh)


class TestPadMaskLayout:
    def test_channel_pad_values(self):
        from tpudas.parallel.sharding import channel_pad as jpad

        for n in (1, 2, 4, 8):
            mesh, jm = make_mesh(n, device=CPU), jmesh.make_mesh(n)
            for c in (1, 3, 10, 16, 6001, 10000):
                assert sharding.channel_pad(c, mesh) == jpad(c, jm)

    def test_pad_channels_host_and_device(self):
        mesh = make_mesh(4, device=CPU)
        x = np.ones((5, 10), np.float32)
        p = sharding.pad_channels(x, mesh)
        assert isinstance(p, np.ndarray) and p.shape == (5, 12)
        assert np.array_equal(p[:, 10:], np.zeros((5, 2)))
        pt = sharding.pad_channels(torch.from_numpy(x), mesh)
        assert isinstance(pt, torch.Tensor) and _equal(pt, p)
        y = np.ones((5, 8), np.float32)
        assert sharding.pad_channels(y, mesh) is y

    def test_place_block_spec_and_gather_roundtrip(self):
        mesh = make_mesh(4, device=CPU)
        x = np.random.default_rng(0).standard_normal((32, 10)).astype(
            np.float32)
        placed = sharding.place_block(x, mesh)
        assert sharding.is_device_resident(placed)
        assert isinstance(placed, sharding.ShardedTensor)
        assert placed.shape == (32, 12)  # padded to the shard multiple
        assert [s.shape[1] for s in placed] == [3, 3, 3, 3]
        (back,) = sharding.gather_leaves((placed,), 10)
        assert isinstance(back, np.ndarray) and np.array_equal(back, x)
        q = (x * 100).astype(np.int16)
        assert sharding.place_block(q, mesh, keep_dtype=True).dtype == \
            torch.int16
        assert not sharding.is_device_resident(x)

    def test_transfer_accounting_equals_jax(self):
        """place/gather bytes land in
        ``tpudas_parallel_transfer_bytes_total`` as in the JAX package."""
        from tpudas.obs.registry import MetricsRegistry as JReg
        from tpudas.obs.registry import use_registry as juse
        from tpudas.parallel import sharding as jsharding
        from tpudas_torch.obs.registry import MetricsRegistry, use_registry

        x = np.zeros((16, 10), np.float32)

        def series(reg):
            snap = reg.snapshot()["tpudas_parallel_transfer_bytes_total"]
            return {tuple(sorted(lab.items())): v for lab, v in snap["series"]}

        out = {}
        for name, reg, use, mod, mesh in (
                ("port", MetricsRegistry(), use_registry, sharding,
                 make_mesh(4, device=CPU)),
                ("jax", JReg(), juse, jsharding, jmesh.make_mesh(4))):
            with use(reg):
                placed = mod.place_block(x, mesh)
                mod.gather_leaves((placed,), 10)
                mod.gather_leaves((np.zeros((4, 10), np.float32),), 10)
            out[name] = series(reg)
        assert out["port"] == out["jax"]
        assert out["port"][(("direction", "place"),)] == 16 * 12 * 4


class TestHaloExchange:
    def _shards(self, x, nt):
        t_loc = x.shape[0] // nt
        return [torch.from_numpy(x[i * t_loc:(i + 1) * t_loc].copy())
                for i in range(nt)]

    def _jax(self, x, halo_rows, left):
        from jax.sharding import PartitionSpec as P

        from tpudas.parallel.compat import shard_map
        from tpudas.parallel.halo import exchange_halo_time as jx

        fn = shard_map(
            lambda b: jx(b, halo_rows, n_shards=4, left=left),
            mesh=jmesh.make_mesh(8, time_shards=4),
            in_specs=P("time", "ch"), out_specs=P("time", "ch"),
            check_vma=False,
        )
        return np.asarray(jax.jit(fn)(x))

    def test_exchange_matches_padded_reference(self):
        T, C, h = 64, 4, 5
        x = np.arange(T * C, dtype=np.float32).reshape(T, C)
        out = halo.exchange_halo_time(self._shards(x, 4), h, n_shards=4)
        t_loc = T // 4
        padded = np.concatenate([np.zeros((h, C), np.float32), x,
                                 np.zeros((h, C), np.float32)])
        ref = np.concatenate([padded[i * t_loc: i * t_loc + t_loc + 2 * h]
                              for i in range(4)])
        assert _equal(torch.cat(out), ref)
        assert _equal(torch.cat(out), self._jax(x, h, True))

    def test_one_sided_exchange_halves_the_extension(self):
        T, C, h = 64, 2, 4
        x = np.arange(T * C, dtype=np.float32).reshape(T, C)
        out = halo.exchange_halo_time(self._shards(x, 4), h, left=False)
        t_loc = T // 4
        padded = np.concatenate([x, np.zeros((h, C), np.float32)])
        ref = np.concatenate([padded[i * t_loc: i * t_loc + t_loc + h]
                              for i in range(4)])
        assert _equal(torch.cat(out), ref)
        assert _equal(torch.cat(out), self._jax(x, h, False))
        # a single shard gets zeros on both sides; int16 stays int16
        (one,) = halo.exchange_halo_time(
            [torch.ones((6, 2), dtype=torch.int16)], 2)
        assert one.dtype == torch.int16 and one.shape == (10, 2)
        assert int(one[:2].abs().sum()) == 0 == int(one[-2:].abs().sum())

    def test_halo_wider_than_shard_rejected(self):
        from tpudas.parallel.halo import exchange_halo_time as jx

        with pytest.raises(ValueError, match="halo"):
            halo.exchange_halo_time([torch.zeros((8, 2))] * 2, 9)
        with pytest.raises(ValueError, match="halo"):
            jx(jax.numpy.zeros((8, 2)), 9, n_shards=2)

    def test_fir_halo_rows_and_layout_equal_jax(self):
        from tpudas.parallel.halo import fir_halo_rows as jhalo
        from tpudas.parallel.pipeline import sharded_cascade_layout as jlay

        for fs, ratio in ((100.0, 20), (200.0, 40), (100.0, 100), (50.0, 7)):
            plan = fir.design_cascade(fs, ratio, 0.45 * fs / ratio, 4)
            jplan = jfir.design_cascade(fs, ratio, 0.45 * fs / ratio, 4)
            for n_loc in (1, 8, 55, 110):
                assert (halo.fir_halo_rows(plan, n_loc)
                        == jhalo(jplan, n_loc) > 0)
            for ts in (1, 2, 4, 8):
                mesh = make_mesh(8, time_shards=ts, device=CPU)
                jm = jmesh.make_mesh(8, time_shards=ts)
                for phase, n_out, T in ((200, 110, 12000), (10, 8, 600),
                                        (plan.delay, 40, 40 * ratio),
                                        (3, 25, 30 * ratio + 7)):
                    got = pipeline.sharded_cascade_layout(
                        mesh, plan, phase, n_out, T)
                    assert got == jlay(jm, jplan, phase, n_out, T), (
                        fs, ratio, ts, phase)


class TestShardedStreamOps:
    """The sharded stream steps equal the single-device steps byte for
    byte, keep their carry on the mesh between calls at the padded
    width, and trim the pad columns on output; every engine, int16 +
    qscale, odd widths, the stacked step."""

    @pytest.mark.parametrize("engine", ["torch", "fused-torch"])
    @pytest.mark.parametrize("n_ch,quantized", [(16, False), (10, True),
                                                (3, False), (1, True)])
    def test_cascade_stream_bit_equal_and_resident(self, engine, n_ch,
                                                   quantized):
        plan, jplan = _plans()
        mesh = make_mesh(4, device=CPU)
        rng = np.random.default_rng(5)
        qs = 1e-3 if quantized else None
        blocks = [rng.integers(-3000, 3000, (t, n_ch)).astype(np.int16)
                  if quantized else
                  rng.standard_normal((t, n_ch)).astype(np.float32)
                  for t in (400, 800, 400)]
        ref = fir.cascade_stream_init(plan, n_ch, CPU)
        sh = fir.cascade_stream_init(plan, n_ch, CPU)
        jc = jfir.cascade_stream_init(jplan, n_ch)
        for blk in blocks:
            y_ref, ref = fir.cascade_decimate_stream(
                torch.from_numpy(blk), ref, plan, engine, qscale=qs)
            y_sh, sh = fir.cascade_decimate_stream(blk, sh, plan, engine,
                                                   qscale=qs, mesh=mesh)
            y_j, jc = jfir.cascade_decimate_stream(blk, jc, jplan, "xla",
                                                   qscale=qs)
            assert torch.equal(y_ref, y_sh)
            _assert_close(y_sh, y_j)
            for leaf in sh:
                assert isinstance(leaf, sharding.ShardedTensor)
                assert leaf.shape[1] == n_ch + (-n_ch % 4)
        for a, b in zip(sharding.gather_leaves(sh, n_ch),
                        sharding.gather_leaves(ref, n_ch)):
            assert np.array_equal(a, b)

    def test_shards_run_the_unsharded_engine(self, monkeypatch):
        """The fused size threshold sees the block's logical width: with
        the threshold between a shard's elements and the block's, every
        shard runs the fused step the unsharded block runs (B3 and the
        B1 chain differ in their last bits on the card)."""
        plan, _ = _plans()
        T, C = 400, 16
        monkeypatch.setenv("TPUDAS_FUSED_MIN_ELEMS", str(T * C))
        ran = []
        real = fir._stream_step
        monkeypatch.setattr(fir, "_stream_step",
                            lambda x, b, p, eng, q: ran.append(eng)
                            or real(x, b, p, eng, q))
        x = np.ones((T, C), np.float32)
        fir.cascade_decimate_stream(x, fir.cascade_stream_init(plan, C, CPU),
                                    plan, "fused", device=CPU)
        fir.cascade_decimate_stream(x, fir.cascade_stream_init(plan, C, CPU),
                                    plan, "fused",
                                    mesh=make_mesh(4, device=CPU))
        assert ran == ["fused-torch"] * 5

    @pytest.mark.parametrize("n_ch,quantized", [(16, False), (10, True),
                                                (3, False)])
    def test_fft_stream_bit_equal_and_resident(self, n_ch, quantized):
        mesh = make_mesh(4, device=CPU)
        rng = np.random.default_rng(6)
        qs = 1e-3 if quantized else None
        blocks = [rng.integers(-3000, 3000, (t, n_ch)).astype(np.int16)
                  if quantized else
                  rng.standard_normal((t, n_ch)).astype(np.float32)
                  for t in (256, 128)]
        ref = tfilter.fft_stream_init(32, n_ch)
        sh = tfilter.fft_stream_init(32, n_ch)
        jc = jfilter.fft_stream_init(32, n_ch)
        for blk in blocks:
            y_ref, ref = tfilter.fft_pass_filter_stream(
                blk, ref, 0.01, high=2.0, qscale=qs, device=CPU)
            y_sh, sh = tfilter.fft_pass_filter_stream(
                blk, sh, 0.01, high=2.0, qscale=qs, mesh=mesh)
            y_j, jc = jfilter.fft_pass_filter_stream(blk, jc, 0.01, high=2.0,
                                                     qscale=qs)
            assert torch.equal(y_ref, y_sh)
            _assert_close(y_sh, y_j)
            assert isinstance(sh, sharding.ShardedTensor)
        (back,) = sharding.gather_leaves((sh,), n_ch)
        assert np.array_equal(back, ref.numpy())

    def test_mismatched_carry_width_rejected(self):
        plan, jplan = _plans()
        x = np.zeros((400, 16), np.float32)
        for step, p, carry, mesh in (
                (fir.cascade_decimate_stream, plan,
                 fir.cascade_stream_init(plan, 6, CPU),
                 make_mesh(4, device=CPU)),
                (jfir.cascade_decimate_stream, jplan,
                 jfir.cascade_stream_init(jplan, 6), jmesh.make_mesh(4))):
            with pytest.raises(ValueError, match="matches neither"):
                step(x, carry, p, "auto" if step is fir.cascade_decimate_stream
                     else "xla", mesh=mesh)
        with pytest.raises(ValueError, match="does not match carry"):
            tfilter.fft_pass_filter_stream(
                x, tfilter.fft_stream_init(8, 6), 0.01, high=2.0,
                mesh=make_mesh(4, device=CPU))

    def test_stacked_steps_under_mesh_equal_solo(self):
        plan, _ = _plans()
        mesh = make_mesh(4, device=CPU)
        rng = np.random.default_rng(8)
        widths = (6, 9, 5)
        blocks = [rng.standard_normal((400, w)).astype(np.float32)
                  for w in widths]
        for engine in ("torch", "fused-torch"):
            carries = [fir.cascade_stream_init(plan, w, CPU) for w in widths]
            got = fir.cascade_decimate_stream_stacked(
                blocks, carries, plan, engine, device=CPU, mesh=mesh)
            for b, c, (y, new) in zip(blocks, carries, got):
                y_ref, c_ref = fir.cascade_decimate_stream(
                    torch.from_numpy(b), c, plan, engine)
                assert torch.equal(y, y_ref)
                assert all(torch.equal(a, r) for a, r in zip(new, c_ref))
        fcarries = [tfilter.fft_stream_init(16, w) for w in widths]
        got = tfilter.fft_pass_filter_stream_stacked(
            blocks, fcarries, 0.01, high=2.0, mesh=mesh)
        for b, c, (y, new) in zip(blocks, fcarries, got):
            y_ref, c_ref = tfilter.fft_pass_filter_stream(
                b, c, 0.01, high=2.0, device=CPU)
            assert torch.equal(y, y_ref)
            assert np.array_equal(
                sharding.gather_leaves((new,), b.shape[1])[0], c_ref.numpy())


class TestShardedCascade:
    """The time-sharded cascade and window DP are layout, not math."""

    @pytest.mark.parametrize("time_shards", [1, 2, 4])
    def test_bit_equal_to_single_device(self, time_shards):
        plan, jplan = _plans()
        mesh = make_mesh(8, time_shards=time_shards, device=CPU)
        x = _signal(12000, 12, 100.0, seed=3)  # 12 ch: pad-and-mask at 8
        ref = fir.cascade_decimate(x, plan, 200, 110, device=CPU)
        out = pipeline.sharded_cascade_decimate(mesh, x, plan, 200, 110)
        assert out is not None and torch.equal(out, ref)
        assert torch.equal(fir.cascade_decimate(x, plan, 200, 110, mesh=mesh),
                           ref)
        _assert_close(out, jfir.cascade_decimate(x, jplan, 200, 110, "xla"))

    def test_quantized_bit_equal_to_single_device(self):
        plan, jplan = _plans()
        mesh = make_mesh(8, time_shards=2, device=CPU)
        q = np.random.default_rng(7).integers(
            -3000, 3000, size=(12000, 12)).astype(np.int16)
        ref = fir.cascade_decimate(q, plan, 200, 110, qscale=1e-3, device=CPU)
        out = pipeline.sharded_cascade_decimate(mesh, q, plan, 200, 110,
                                                qscale=1e-3)
        assert out is not None and torch.equal(out, ref)
        _assert_close(out, jfir.cascade_decimate(q, jplan, 200, 110, "xla",
                                                 qscale=1e-3))
        with pytest.raises(ValueError, match="qscale"):
            pipeline.sharded_cascade_decimate(
                mesh, q.astype(np.float32), plan, 200, 110, qscale=1e-3)

    def test_unfit_layout_returns_none(self):
        from tpudas.parallel.pipeline import sharded_cascade_decimate as js

        plan, jplan = _plans()
        x = _signal(600, 4, 100.0)
        assert pipeline.sharded_cascade_decimate(
            make_mesh(8, time_shards=8, device=CPU), x, plan, 10, 8) is None
        assert js(jmesh.make_mesh(8, time_shards=8), x, jplan, 10, 8) is None

    def test_window_dp_matches_per_window(self):
        plan, jplan = _plans()
        mesh = make_mesh(8, time_shards=2, device=CPU)
        rng = np.random.default_rng(9)
        stack = rng.standard_normal((3, 9000, 6)).astype(np.float32)
        out = batched_cascade_decimate(mesh, stack, plan, 150, 80)
        assert out.shape == (3, 80, 6)
        for w in range(3):
            ref = fir.cascade_decimate(stack[w], plan, 150, 80, device=CPU)
            assert torch.equal(out[w], ref), w
            _assert_close(out[w], jfir.cascade_decimate(
                stack[w], jplan, 150, 80, "xla"))

    def test_window_dp_quantized_and_single_axis_mesh(self):
        plan, _ = _plans()
        rng = np.random.default_rng(10)
        q = rng.integers(-3000, 3000, size=(4, 9000, 8)).astype(np.int16)
        out = batched_cascade_decimate(
            make_mesh(8, time_shards=4, device=CPU), q, plan, 150, 80,
            qscale=1e-3)
        win = DeviceMesh(["cpu"] * 4, axis_names=("win",))
        out2 = batched_cascade_decimate(win, q, plan, 150, 80, qscale=1e-3,
                                        batch_axis="win")
        for w in range(4):
            ref = fir.cascade_decimate(q[w], plan, 150, 80, qscale=1e-3,
                                       device=CPU)
            assert torch.equal(out[w], ref) and torch.equal(out2[w], ref)


class TestBatchedRolling:
    def test_matches_per_patch_kernel(self):
        from tpudas.ops.rolling import rolling_reduce as jroll
        from tpudas_torch.ops.rolling import rolling_reduce

        rng = np.random.default_rng(3)
        batch = rng.standard_normal((5, 500, 4)).astype(np.float32)
        out = batched_rolling_mean(make_mesh(2, device=CPU), batch, 50, 25)
        for b in range(5):
            ref = rolling_reduce(batch[b], 50, 25, "mean", device=CPU)
            assert torch.equal(out[b].isnan(), ref.isnan())
            assert torch.equal(torch.nan_to_num(out[b]),
                               torch.nan_to_num(ref))
            j = np.asarray(jroll(batch[b], 50, 25, "mean"))
            assert np.allclose(out[b].numpy(), j, atol=1e-5, equal_nan=True)


class TestShardedPipeline:
    fs = 100.0

    @pytest.mark.parametrize("time_shards", [2, 4])
    def test_matches_jax_and_seams_are_clean(self, time_shards):
        from tpudas.parallel.pipeline import sharded_lowpass_decimate as jsl

        T, C, ratio, h = 4000, 8, 10, 250
        data = _signal(T, C, self.fs, seed=2)
        out = pipeline.sharded_lowpass_decimate(
            make_mesh(8, time_shards=time_shards, device=CPU), data,
            1 / self.fs, 2.0, ratio, h)
        assert out.shape == (T // ratio, C)
        ref = np.asarray(jsl(jmesh.make_mesh(8, time_shards=time_shards),
                             data, 1 / self.fs, 2.0, ratio, h))
        _assert_close(out, ref)
        padded = np.concatenate([np.zeros((h, C), np.float32), data,
                                 np.zeros((h, C), np.float32)])
        whole = tfilter.fft_pass_filter(padded, 1 / self.fs, high=2.0,
                                        device=CPU).numpy()
        want = whole[h: h + T: ratio]
        assert np.abs(out.numpy() - want).max() < 5e-3 * np.abs(want).max()

    def test_alignment_validation(self):
        mesh = make_mesh(8, time_shards=2, device=CPU)
        with pytest.raises(ValueError, match="divisible"):
            pipeline.sharded_lowpass_decimate(
                mesh, np.zeros((4001, 16), np.float32), 0.01, 2.0, 10, 100)
        with pytest.raises(ValueError, match="halo"):
            pipeline.sharded_lowpass_decimate(
                mesh, np.zeros((4000, 16), np.float32), 0.01, 2.0, 10, 2000)


class TestWindowDPLatch:
    """A failed batch computation latches window DP off once and the
    run finishes window by window; a kernel that fails to build or
    launch is re-raised, never latched."""

    def _run(self, tmp_path, monkeypatch, exc, events):
        import tpudas_torch.parallel.batch as batch_mod
        from tpudas.testing import make_synthetic_spool
        from tpudas_torch.io.spool import spool
        from tpudas_torch.proc.lfproc import LFProc
        from tpudas_torch.utils.logging import set_log_handler

        d = tmp_path / "raw"
        make_synthetic_spool(d, n_files=6, file_duration=30.0, fs=100.0,
                             n_ch=6, noise=0.01)

        def boom(*a, **k):
            raise exc

        monkeypatch.setattr(batch_mod, "batched_cascade_decimate", boom)
        set_log_handler(events.append)
        lfp = LFProc(spool(str(d)).sort("time").update(),
                     mesh=make_mesh(8, time_shards=2, device=CPU), device=CPU)
        lfp.update_processing_parameter(output_sample_interval=1.0,
                                        process_patch_size=60,
                                        edge_buff_size=10, window_dp=True)
        out = tmp_path / "out"
        lfp.set_output_folder(str(out), delete_existing=True)
        try:
            lfp.process_time_range(np.datetime64("2023-03-22T00:00:00"),
                                   np.datetime64("2023-03-22T00:03:00"))
        finally:
            set_log_handler(None)
        return lfp, out

    def test_lfproc_window_dp_failure_latches_off(self, tmp_path,
                                                  monkeypatch):
        events = []
        lfp, out = self._run(tmp_path, monkeypatch,
                             RuntimeError("batch compute failure"), events)
        assert not lfp._window_dp_ok
        falls = [e for e in events if e["event"] == "window_dp_fallback"]
        assert len(falls) == 1, falls
        assert sum(lfp.engine_counts.values()) == 4
        assert len(list(out.iterdir())) == 4

    def test_kernel_error_is_reraised_not_latched(self, tmp_path,
                                                  monkeypatch):
        events = []
        with pytest.raises(KernelError, match="launch failed"):
            self._run(tmp_path, monkeypatch,
                      KernelError("fir_decimate kernel launch failed"),
                      events)
        assert not [e for e in events if e["event"] == "window_dp_fallback"]
