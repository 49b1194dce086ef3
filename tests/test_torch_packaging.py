"""The port installs whole: ``pyproject.toml`` lists every package of
``tpudas_torch/`` and ships every non-Python source the port builds at
first use (the CUDA kernels ``csrc/*.cu``, the native ingest runtime
``native/*.cpp``), and a wheel built offline from the repo's sources
imports ``LFProc`` from its installed tree alone."""

import glob
import os
import shutil
import subprocess
import sys
import tomllib
import zipfile

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _setuptools_config():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as fh:
        return tomllib.load(fh)["tool"]["setuptools"]


def _port_packages():
    """Dotted names of the directories under ``tpudas_torch/`` holding an
    ``__init__.py``."""
    out = set()
    for dirpath, dirs, files in os.walk(os.path.join(REPO, "tpudas_torch")):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        if "__init__.py" in files:
            out.add(os.path.relpath(dirpath, REPO).replace(os.sep, "."))
    return out


def _covered(path, package_data):
    """Whether the file ``path`` (relative to the repo) is matched by a
    package-data pattern of the package that holds it."""
    for package, patterns in package_data.items():
        base = package.replace(".", os.sep)
        for pat in patterns:
            if path in {os.path.relpath(p, REPO) for p in glob.glob(
                    os.path.join(REPO, base, pat))}:
                return True
    return False


def test_every_port_package_is_listed():
    listed = {p for p in _setuptools_config()["packages"]
              if p == "tpudas_torch" or p.startswith("tpudas_torch.")}
    assert listed == _port_packages()
    assert {"tpudas_torch.compat", "tpudas_torch.compat.dascore",
            "tpudas_torch.compat.dascore.utils"} <= listed


def test_every_source_built_at_first_use_is_package_data():
    package_data = _setuptools_config()["package-data"]
    sources = sorted(
        os.path.relpath(p, REPO) for pat in ("csrc/*.cu", "native/*.cpp")
        for p in glob.glob(os.path.join(REPO, "tpudas_torch", pat)))
    assert any(s.endswith(".cu") for s in sources)
    assert any(s.endswith(".cpp") for s in sources)
    for path in sources:
        assert _covered(path, package_data), path


@pytest.fixture(scope="module")
def wheel(tmp_path_factory):
    """A wheel built offline (no index, no build isolation) from a copy
    of the sources the packaging names."""
    if shutil.which("pip") is None and subprocess.run(
            [sys.executable, "-m", "pip", "--version"],
            capture_output=True).returncode != 0:
        pytest.skip("pip is not available")
    src = tmp_path_factory.mktemp("src")
    ignore = shutil.ignore_patterns("__pycache__", "*.pyc", "*.so")
    for name in ("tpudas", "tpudas_torch", "dascore"):
        shutil.copytree(os.path.join(REPO, name), src / name, ignore=ignore)
    for name in ("pyproject.toml", "README.md", "lf_das.py"):
        shutil.copy(os.path.join(REPO, name), src / name)
    dist = tmp_path_factory.mktemp("dist")
    out = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "--no-deps",
         "--no-build-isolation", "--no-index", "-q", "-w", str(dist),
         str(src)],
        capture_output=True, text=True, timeout=240, cwd=str(src))
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    (whl,) = glob.glob(str(dist / "*.whl"))
    return whl


def test_wheel_ships_the_port_and_its_sources(wheel):
    names = set(zipfile.ZipFile(wheel).namelist())
    for pkg in _port_packages():
        assert pkg.replace(".", "/") + "/__init__.py" in names, pkg
    for pat in ("csrc/*.cu", "native/*.cpp"):
        for p in glob.glob(os.path.join(REPO, "tpudas_torch", pat)):
            rel = os.path.relpath(p, REPO).replace(os.sep, "/")
            assert rel in names, rel


def test_installed_tree_imports_lfproc(wheel, tmp_path):
    site = tmp_path / "site"
    zipfile.ZipFile(wheel).extractall(site)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(site)
    probe = (
        "import sys, tpudas_torch.proc.lfproc as m, tpudas_torch.native as n;"
        "import tpudas_torch.compat.lf_das as lf;"
        "print(m.__file__); print(n.streamio_path().name);"
        "print(lf.LFProc is m.LFProc)"
    )
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, env=env, cwd=str(tmp_path), timeout=120)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.split()
    assert lines[0].startswith(str(site)), lines
    # the native runtime's library name hashes its shipped source
    assert lines[1].startswith("libstreamio-"), lines
    assert lines[-1] == "True"
