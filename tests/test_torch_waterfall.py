"""tpudas_torch.viz against tpudas.viz: the same rasters.

Over the output folder of ``tests/test_torch_tiles.py`` with a pyramid
(``tile_len`` 16, factor 4), ``Patch.viz.waterfall(pyramid=...)`` and
``patch_waterfall`` must draw the JAX ``patch_waterfall``'s raster (the
image array, byte for byte, and the same extent and limits), and
``_pyramid_block`` must return the JAX one's data, times and distance;
``waterfall_plot`` must write the same JPEG and print the same guard
messages.  Drawn with the Agg backend.
"""

import os

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import matplotlib
import numpy as np
import pytest

from tpudas.core.patch import Patch as JPatch
from tpudas.serve import tiles as jtiles
from tpudas.viz import waterfall as jwf
from tpudas_torch.io.spool import spool as tspool
from tpudas_torch.viz import waterfall as twf
from test_torch_tiles import GEOM, _copy, outputs  # noqa: F401

matplotlib.use("Agg")


@pytest.fixture(scope="module")
def folder(outputs, tmp_path_factory):  # noqa: F811
    d = _copy(outputs, str(tmp_path_factory.mktemp("wf")))
    jtiles.sync_pyramid(d, **GEOM)
    return d


def _patches(folder):
    parts = tspool(folder).update().chunk(time=None)
    assert len(parts) == 2  # the stream's 5 s gap splits it
    tp = parts[1]
    jp = JPatch(data=tp.host_data(), coords=dict(tp.coords), dims=tp.dims,
                attrs=tp.attrs.to_dict())
    return tp, jp


def _image(ax):
    im = ax.images[-1]
    return np.asarray(im.get_array()), im.get_extent(), im.get_clim()


@pytest.mark.parametrize("max_px", [8, 40, 100, 10_000])
def test_patch_waterfall_matches_jax(folder, max_px):
    import matplotlib.pyplot as plt

    tp, jp = _patches(folder)
    got = _image(tp.viz.waterfall(pyramid=folder, max_px=max_px))
    want = _image(jwf.patch_waterfall(jp, pyramid=folder, max_px=max_px))
    direct = _image(twf.patch_waterfall(tp, pyramid=folder, max_px=max_px,
                                        scale=0.5))
    plt.close("all")
    assert got[0].shape == want[0].shape
    assert got[0].tobytes() == want[0].tobytes()
    assert got[1] == want[1] and got[2] == want[2]
    n_t = tp.coords["time"].size
    if max_px * 4 <= n_t:
        # rastered from a coarser pyramid level (the coarsest whose
        # step fits the budget)
        assert got[0].shape[1] < n_t
    else:
        assert got[0].shape[1] == n_t
    assert direct[0].tobytes() == got[0].tobytes()
    assert direct[2] == tuple(0.5 * v for v in got[2])


def test_pyramid_block_matches_jax(folder, tmp_path):
    tp, jp = _patches(folder)
    got = twf._pyramid_block(tp, folder, 16)
    want = jwf._pyramid_block(jp, folder, 16)
    for a, b in zip(got, want):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    # no pyramid: None in both (the caller draws the full patch)
    bare = _copy_outputs_only(folder, str(tmp_path / "bare"))
    assert twf._pyramid_block(tp, bare, 16) is None
    assert jwf._pyramid_block(jp, bare, 16) is None


def _copy_outputs_only(src, dst):
    os.makedirs(dst)
    for n in os.listdir(src):
        if n.startswith("LFDAS_"):
            os.link(os.path.join(src, n), os.path.join(dst, n))
    return dst


def test_waterfall_plot_same_jpeg_and_guards(tmp_path, capsys):
    import matplotlib.pyplot as plt

    rng = np.random.default_rng(0)
    data = rng.standard_normal((32, 400)).astype(np.float32)
    args = (0, 3, 2, 30, 100, 1.02, 20.0, 10.0, "QC")
    for name, mod in (("port", twf), ("jax", jwf)):
        mod.waterfall_plot(data, *args, str(tmp_path), name)
    plt.close("all")
    with open(tmp_path / "port.jpeg", "rb") as a, \
            open(tmp_path / "jax.jpeg", "rb") as b:
        assert a.read() == b.read()
    capsys.readouterr()
    for bad in ((3, 2, 2, 30), (0, 3, 30, 2), (0, 300, 2, 30)):
        twf.waterfall_plot(data, *bad, *args[4:], str(tmp_path), "x")
        port = capsys.readouterr().out
        jwf.waterfall_plot(data, *bad, *args[4:], str(tmp_path), "x")
        ref = capsys.readouterr().out
        assert port == ref
        assert "error in plotspacetime" in port.lower()
    assert not (tmp_path / "x.jpeg").exists()
