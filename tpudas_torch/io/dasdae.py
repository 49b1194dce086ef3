"""dasdae-format HDF5 read/write/scan (h5py-based).

The port's copy of :mod:`tpudas.io.dasdae`.  ``h5py`` is imported
inside the functions only, so the port imports (and runs its tdas
path) on a machine without it.

Layout (self-describing, round-trips a Patch exactly):

.. code-block:: text

    /                  attrs: __format__="DASDAE", __version__, dims (csv)
    /data              the (time x distance) array
    /coords/<dim>      coordinate axes; time stored as int64 ns since epoch
    /patch_attrs       attrs: one HDF5 attr per patch attr, typed via a
                       companion "<key>__type" tag for datetime64 /
                       timedelta64 values (stored as int64 ns)

``scan`` reads only root attrs + coordinate endpoints (no data), which
is what makes directory indexing cheap; ``read`` supports time/distance
range slicing so the overlap-save engine only pulls the window it needs
from disk.
"""

from __future__ import annotations

import numpy as np

from tpudas_torch.core.patch import Patch
from tpudas_torch.core.timeutils import to_datetime64

FORMAT_NAME = "DASDAE"
FORMAT_VERSION = "1.0"

_TIME_DTYPE = "datetime64[ns]"


def _encode_attr(group, key, value):
    if isinstance(value, np.datetime64):
        group.attrs[key] = int(value.astype(_TIME_DTYPE).astype(np.int64))
        group.attrs[key + "__type"] = "dt64"
    elif isinstance(value, np.timedelta64):
        group.attrs[key] = int(value.astype("timedelta64[ns]").astype(np.int64))
        group.attrs[key + "__type"] = "td64"
    elif value is None:
        group.attrs[key] = "__none__"
        group.attrs[key + "__type"] = "none"
    else:
        try:
            group.attrs[key] = value
        except TypeError:
            group.attrs[key] = str(value)


def _decode_attrs(group) -> dict:
    out = {}
    raw = dict(group.attrs)
    for key, value in raw.items():
        if key.endswith("__type"):
            continue
        tag = raw.get(key + "__type")
        if tag == "dt64":
            out[key] = np.datetime64(int(value), "ns")
        elif tag == "td64":
            out[key] = np.timedelta64(int(value), "ns")
        elif tag == "none":
            out[key] = None
        else:
            if isinstance(value, bytes):
                value = value.decode()
            out[key] = value
    return out


def write_dasdae(patch: Patch, path, **kwargs) -> None:
    import h5py

    data = patch.host_data()
    with h5py.File(path, "w") as f:
        f.attrs["__format__"] = FORMAT_NAME
        f.attrs["__version__"] = FORMAT_VERSION
        f.attrs["dims"] = ",".join(patch.dims)
        f.create_dataset("data", data=data)
        cg = f.create_group("coords")
        for dim in patch.dims:
            axis = patch.coords[dim]
            if np.issubdtype(axis.dtype, np.datetime64):
                ds = cg.create_dataset(
                    dim, data=axis.astype(_TIME_DTYPE).astype(np.int64)
                )
                ds.attrs["dtype"] = "dt64"
            else:
                cg.create_dataset(dim, data=axis)
        ag = f.create_group("patch_attrs")
        for key, value in patch.attrs.to_dict().items():
            _encode_attr(ag, key, value)


def _read_coord(ds):
    arr = ds[()]
    if ds.attrs.get("dtype") == "dt64":
        arr = arr.astype(np.int64).astype(_TIME_DTYPE)
    return arr


def _is_dasdae_h5(f) -> bool:
    fmt = f.attrs.get("__format__")
    if isinstance(fmt, bytes):
        fmt = fmt.decode()
    return fmt == FORMAT_NAME


def read_dasdae(path, time=None, distance=None) -> list:
    """Read a file → [Patch], optionally sliced to the (inclusive)
    time/distance ranges without loading the rest of the data."""
    import h5py

    with h5py.File(path, "r") as f:
        if not _is_dasdae_h5(f):
            raise ValueError(f"{path} is not a dasdae file")
        dims = f.attrs["dims"]
        if isinstance(dims, bytes):
            dims = dims.decode()
        dims = tuple(dims.split(","))
        coords = {dim: _read_coord(f["coords"][dim]) for dim in dims}
        slices = []
        for dim in dims:
            axis = coords[dim]
            bounds = time if dim == "time" else (distance if dim == "distance" else None)
            if bounds is None:
                slices.append(slice(None))
                continue
            lo, hi = bounds
            if dim == "time":
                lo = None if lo is None else to_datetime64(lo)
                hi = None if hi is None else to_datetime64(hi)
            mask = np.ones(len(axis), bool)
            if lo is not None:
                mask &= axis >= lo
            if hi is not None:
                mask &= axis <= hi
            idx = np.nonzero(mask)[0]
            if idx.size == 0:
                sl = slice(0, 0)
            else:
                sl = slice(int(idx[0]), int(idx[-1]) + 1)
            coords[dim] = axis[sl]
            slices.append(sl)
        data = f["data"][tuple(slices)]
        attrs = _decode_attrs(f["patch_attrs"])
    return [Patch(data=data, coords=coords, dims=dims, attrs=attrs)]


def scan_dasdae(path) -> list:
    """Metadata-only scan → [dict]; no array data is read."""
    import h5py

    with h5py.File(path, "r") as f:
        if not _is_dasdae_h5(f):
            raise ValueError(f"{path} is not a dasdae file")
        dims = f.attrs["dims"]
        if isinstance(dims, bytes):
            dims = dims.decode()
        dims = tuple(dims.split(","))
        info = {"path": str(path), "format": "dasdae", "dims": ",".join(dims)}
        shape = f["data"].shape
        for dim in dims:
            ds = f["coords"][dim]
            n = ds.shape[0]
            first = ds[0] if n else None
            last = ds[n - 1] if n else None
            if ds.attrs.get("dtype") == "dt64":
                first = np.datetime64(int(first), "ns") if n else None
                last = np.datetime64(int(last), "ns") if n else None
                if n > 1:
                    step = np.timedelta64(
                        int(round((int(ds[n - 1]) - int(ds[0])) / (n - 1))), "ns"
                    )
                else:
                    step = np.timedelta64(0, "ns")
                info["time_min"], info["time_max"], info["time_step"] = (
                    first,
                    last,
                    step,
                )
                info["ntime"] = n
            else:
                info[f"{dim}_min"] = float(first) if n else np.nan
                info[f"{dim}_max"] = float(last) if n else np.nan
                info[f"n{dim}"] = n
        info["shape"] = shape
        attrs = _decode_attrs(f["patch_attrs"])
        for k in ("gauge_length",):
            if k in attrs:
                info[k] = attrs[k]
    return [info]
