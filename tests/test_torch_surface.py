"""The port's public surface against the JAX package's: every
``__init__.py`` pair exports the same names (the port's top level also
``resolve_device``), each name resolves to a port object, the version
is the JAX package's, the DASCore-compatible entry
(``tpudas_torch.compat``) exposes the names of the repo's ``dascore/``
and ``lf_das.py`` shims, and ``default_device`` routes ``None`` for the
process while it is entered."""

import importlib
import inspect
import os
import threading

import pytest
import torch

import tpudas
import tpudas_torch
from tpudas_torch.device import default_device, resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _subpackages(root):
    """Dotted names of the directories under ``root`` with an
    ``__init__.py``."""
    out = []
    for dirpath, dirs, files in os.walk(os.path.join(REPO, root)):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        if "__init__.py" in files:
            out.append(os.path.relpath(dirpath, REPO).replace(os.sep, "."))
    return sorted(out)


def _pairs():
    """(port package, JAX package) for every JAX subpackage."""
    return [("tpudas_torch" + name[len("tpudas"):], name)
            for name in _subpackages("tpudas")]


# The JAX native package defines no __all__; the port's exports its
# loader's names (its loader raises where the JAX one falls back, ROADMAP
# C, documented differences).  The only pair whose exports differ.
PORT_ONLY_ALL = {"tpudas.native"}


def test_every_jax_subpackage_has_its_port_counterpart():
    port = set(_subpackages("tpudas_torch"))
    for tname, _jname in _pairs():
        assert tname in port, tname


@pytest.mark.parametrize("tname,jname", _pairs())
def test_all_equal_and_names_resolve_to_port_objects(tname, jname):
    tmod = importlib.import_module(tname)
    jmod = importlib.import_module(jname)
    if not hasattr(jmod, "__all__"):
        assert hasattr(tmod, "__all__") == (jname in PORT_ONLY_ALL), tname
        want = None
    else:
        want = list(jmod.__all__)
        if tname == "tpudas_torch":
            want = ["resolve_device", *want]
        assert sorted(tmod.__all__) == sorted(want)
        assert len(set(tmod.__all__)) == len(tmod.__all__)
    for name in getattr(tmod, "__all__", ()):
        obj = getattr(tmod, name)
        if inspect.ismodule(obj):
            assert obj.__name__.startswith("tpudas_torch."), (tname, name)
        elif callable(obj):
            owner = obj.__module__
            assert owner.split(".")[0] == "tpudas_torch", (tname, name, owner)
            # the port object is the one its defining module holds
            home = importlib.import_module(owner)
            assert getattr(home, obj.__name__, obj) is obj, (tname, name)
        elif want is not None:
            # a constant (CRC_KEY, RESOURCE_ERRNOS, MAGIC, __version__,
            # ...): the JAX package's value
            jobj = getattr(jmod, name)
            assert obj == jobj or repr(obj) == repr(jobj), (tname, name)


def test_version_is_the_jax_packages():
    assert tpudas_torch.__version__ == tpudas.__version__ == "0.8.0"


def test_subpackages_and_lazy_names_resolve():
    for name in ("integrity", "obs", "resilience", "serve"):
        assert getattr(tpudas_torch, name) is importlib.import_module(
            f"tpudas_torch.{name}")
    with pytest.raises(AttributeError):
        tpudas_torch.no_such_name  # noqa: B018
    # PEP 562 names of the processing package keep resolving
    from tpudas_torch.proc import run_rolling_realtime
    from tpudas_torch.proc.streaming import run_rolling_realtime as rr

    assert run_rolling_realtime is rr


def test_integrity_audit_is_the_function():
    """As in the JAX package, ``integrity.audit`` is the audit function
    once the package is imported (the module stays importable by its
    dotted name)."""
    import tpudas.integrity as jint
    import tpudas_torch.integrity as tint

    assert callable(tint.audit) and callable(jint.audit)
    assert tint.audit.__name__ == jint.audit.__name__ == "audit"
    mod = importlib.import_module("tpudas_torch.integrity.audit")
    assert mod.audit is tint.audit


@pytest.mark.parametrize("shim,port", [
    ("dascore", "tpudas_torch.compat.dascore"),
    ("dascore.units", "tpudas_torch.compat.dascore.units"),
    ("dascore.utils", "tpudas_torch.compat.dascore.utils"),
    ("dascore.utils.mapping", "tpudas_torch.compat.dascore.utils.mapping"),
    ("lf_das", "tpudas_torch.compat.lf_das"),
])
def test_compat_entry_exposes_the_shims_names(shim, port):
    smod = importlib.import_module(shim)
    pmod = importlib.import_module(port)
    assert sorted(pmod.__all__) == sorted(smod.__all__)
    for name in pmod.__all__:
        pobj, sobj = getattr(pmod, name), getattr(smod, name)
        if name == "__version__":
            assert pobj == sobj
        elif isinstance(pobj, type(importlib)):
            assert pobj.__name__ == port + "." + name
        else:
            assert type(pobj).__name__ == type(sobj).__name__, name
            owner = getattr(pobj, "__module__", "tpudas_torch")
            if callable(pobj):
                assert owner.startswith("tpudas_torch."), (name, owner)
    if shim == "lf_das":
        # the underscored aliases name the same port functions
        from tpudas_torch.proc.edge import down_sample_processing
        from tpudas_torch.proc.lfproc import check_merge
        from tpudas_torch.proc.naming import get_filename, get_timestr

        assert pmod._check_merge is check_merge
        assert pmod._get_filename is get_filename
        assert pmod._get_timestr is get_timestr
        assert pmod._down_sample_processing is down_sample_processing


def test_compat_units_values_equal():
    import dascore.units as ju
    import tpudas_torch.compat.dascore.units as tu

    for name in ("ns", "us", "ms", "s", "minute", "h"):
        assert ju.get_seconds(getattr(ju, name)) == tu.get_seconds(
            getattr(tu, name)), name


def test_default_device_routes_none_and_restores():
    cpu = torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device(None)
    with default_device("cpu") as dev:
        assert dev == cpu
        assert resolve_device(None) == cpu
        assert resolve_device("cpu") == cpu
        # process wide: another thread sees it too
        seen = []
        t = threading.Thread(target=lambda: seen.append(resolve_device(None)))
        t.start()
        t.join()
        assert seen == [cpu]
        with default_device("cpu"):  # nests
            assert resolve_device(None) == cpu
        assert resolve_device(None) == cpu
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device(None)
    # an exception inside restores the default too
    with pytest.raises(ValueError):
        with default_device("cpu"):
            raise ValueError("inside")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device(None)
    with pytest.raises(ValueError):
        with default_device("mps"):
            pass


def test_default_device_reaches_an_entry_point():
    """``LFProc(sp)`` with no device takes the block's device."""
    import numpy as np

    from tpudas_torch.core.patch import Patch
    from tpudas_torch.io.spool import spool
    from tpudas_torch.proc.lfproc import LFProc

    data = np.zeros((100, 2), np.float32)
    times = (np.datetime64("2023-03-22T00:00:00", "ns")
             + np.arange(100) * np.timedelta64(10_000_000, "ns"))
    patch = Patch(data=data, coords={"time": times,
                                     "distance": np.arange(2.0)},
                  dims=("time", "distance"))
    with default_device("cpu"):
        lfp = LFProc(spool([patch]))
    assert lfp.device == torch.device("cpu")
