"""Joint low-pass + rolling-mean pipeline (BASELINE.md config 5).

The port's counterpart of :mod:`tpudas.proc.joint`.  The reference
computes its two products in two separate passes over the spool: the
LF pipeline (``lf_das.py:219-290``) and the per-patch rolling mean
(``rolling_mean_dascore.ipynb:148``).  :class:`JointProc` produces BOTH
from ONE ingest pass: every loaded overlap-save window feeds the
low-pass/decimate engine unchanged AND a trailing rolling mean, sharing
index planning, the native window assembly and the H2D transfer (the
staged device window of the prefetch thread, with no second H2D).

The rolling product here is *seam-free*: each emitted rolling sample's
trailing window is fully covered by the loaded halo, so consecutive
windows tile into one gapless stream — unlike the reference's
per-patch rolling, whose NaN warm-up prefix restarts at every file
boundary (``rolling_mean_dascore_edge.ipynb:209-221``) and is dropped
with ``dropna("time")``.  Only the run's very first window has a
warm-up clamp (there is genuinely no earlier data), matching the
reference's dropna semantics at the stream head.

Alignment contract: rolling output positions sit on the global grid
``run_bgtime + k * rolling_step`` (phased in input samples from the
run origin).  For crash-resume alignment across runs, use a
``rolling_step`` that divides ``output_sample_interval`` — then the
resume rewind (a whole number of output steps) is also a whole number
of rolling steps.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from tpudas_torch.ops.rolling import _windowed
from tpudas_torch.proc.lfproc import LFProc
from tpudas_torch.proc.naming import get_filename
from tpudas_torch.utils.logging import log_event

__all__ = ["JointProc"]


def _trailing_mean(x, w: int, s: int, qscale=None):
    """Mean over trailing windows of ``w`` rows at stride ``s`` of the
    (T, C) tensor ``x``, pandas-aligned to the first row of ``x`` being
    position w-1: a direct windowed sum divided by ``w`` (a cumulative
    sum difference would cancel over a window's tens of thousands of
    float32 rows).  int16 payloads are cast exactly and scaled AFTER
    the reduction (the mean is linear)."""
    red = _windowed(x.to(torch.float32), w, s, "mean")
    if qscale is not None:
        red = red * torch.tensor(np.float32(qscale), device=red.device)
    return red


class JointProc(LFProc):
    """LFProc plus a rolling-mean product from the same ingest pass.

    Configure with the two extra parameters ``rolling_window`` /
    ``rolling_step`` (seconds) and call :meth:`set_rolling_output_folder`
    before :meth:`process_time_range`; everything else — scheduling,
    engines, gap policy, resume — is inherited LFProc behavior and the
    LF output is byte-identical to a plain LFProc run.
    """

    def _default_process_parameters(self):
        p = super()._default_process_parameters()
        p.update(
            {
                # trailing-mean geometry, in seconds (reference rolling
                # call: patch.rolling(time=w, step=s).mean())
                "rolling_window": 1.0,
                "rolling_step": 1.0,
            }
        )
        return p

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._rolling_output_folder = None
        self.rolling_windows = 0  # emitted rolling files (ground truth)

    def set_rolling_output_folder(self, folder, delete_existing=False):
        """Mirror of :meth:`set_output_folder` for the rolling product."""
        self._rolling_output_folder = folder
        self._setup_folder(folder, delete_existing)

    def process_time_range(self, bgtime, edtime):
        # fail loudly BEFORE the first window writes anything: the
        # rolling geometry and the halo relation are derivable from
        # the config plus the spool index
        if self._rolling_output_folder is not None:
            d_sec = self._index_sample_step()
            if d_sec is not None:
                w = int(round(float(self._para["rolling_window"]) / d_sec))
                s = int(round(float(self._para["rolling_step"]) / d_sec))
                if w < 1 or s < 1:
                    raise ValueError(
                        "rolling_window / rolling_step shorter than one "
                        f"input sample at {1 / d_sec:.6g} Hz"
                    )
                halo_in = int(round(
                    float(self._para["edge_buff_size"])
                    * float(self._para["output_sample_interval"]) / d_sec
                ))
                if w - 1 > halo_in:
                    raise ValueError(
                        f"rolling_window ({w} input samples) exceeds "
                        f"the edge halo ({halo_in}); increase "
                        "edge_buff_size so the rolling product stays "
                        "seam-free"
                    )
        return super().process_time_range(bgtime, edtime)

    def _index_sample_step(self):
        """Input sample step (s) from the spool index, or None when
        the index has no step (validation then falls back to the
        in-run check)."""
        rows = self._spool.contents()
        step = rows[0].get("time_step") if rows else None
        if step is None:
            return None
        return float(np.timedelta64(step, "ns") / np.timedelta64(1, "s"))

    # the hook ---------------------------------------------------------
    def _emit_window_extras(self, window_patch, payload, qs, taxis,
                            target_times, dt, d_sec):
        folder = self._rolling_output_folder
        first = self._first_window_of_run
        self._first_window_of_run = False
        if folder is None or target_times.size == 0:
            return
        w = int(round(float(self._para["rolling_window"]) / d_sec))
        s = int(round(float(self._para["rolling_step"]) / d_sec))
        if w < 1 or s < 1:
            raise ValueError(
                "rolling_window / rolling_step shorter than one input "
                f"sample ({self._para['rolling_window']} / "
                f"{self._para['rolling_step']} s at {1 / d_sec:.6g} Hz)"
            )
        # the halo relation, re-checked against the actual sample rate
        # of the loaded window (the index may carry no step)
        halo_in = int(round(
            float(self._para["edge_buff_size"]) * float(dt) / d_sec
        ))
        if w - 1 > halo_in:
            raise ValueError(
                f"rolling_window ({w} input samples) exceeds the edge "
                f"halo ({halo_in}); increase edge_buff_size so the "
                "rolling product stays seam-free"
            )
        step_ns = int(round(d_sec * 1e9))
        t0_ns = int(taxis[0].astype("datetime64[ns]").astype(np.int64))
        origin = self._run_origin_ns
        if origin is None:  # direct _process_window use: window-local
            origin = t0_ns
        n0 = round((t0_ns - origin) / step_ns)  # window start, global
        T = int(payload.shape[0])

        def _local(tns):
            return round((int(tns) - t0_ns) / step_ns)

        # the window's rolling span mirrors the LF emit interior: from
        # the first emitted output time to one output step past the
        # last — consecutive windows therefore tile with no overlap
        e_lo = _local(target_times[0].astype("datetime64[ns]").astype(np.int64))
        e_hi = _local(
            target_times[-1].astype("datetime64[ns]").astype(np.int64)
        ) + max(int(round(dt / d_sec)), 1)
        e_hi = min(e_hi, T)
        # first global-grid position (n0+q) % s == 0 inside the span
        q = e_lo + (-(n0 + e_lo)) % s
        if q - w + 1 < 0:
            # not enough trailing history before the emit interior
            if not first:
                raise ValueError(
                    f"rolling_window ({w} input samples) exceeds the "
                    "window's leading halo; increase edge_buff_size so "
                    "interior windows keep the rolling product seam-free"
                )
            # stream head: clamp forward like the reference's dropna
            short = (w - 1 - q + s - 1) // s
            q += short * s
        if q >= e_hi:
            return
        m = (e_hi - 1 - q) // s + 1
        t_dev0 = time.perf_counter()
        x = payload[q - w + 1 : q + (m - 1) * s + 1]
        red = _trailing_mean(x, w, s, qs).cpu().numpy()
        t_dev = time.perf_counter() - t_dev0
        self.timings["device_s"] += t_dev
        times = taxis[q : q + m * s : s]
        coords = dict(window_patch.coords)
        coords["time"] = times
        attrs = window_patch.attrs.to_dict()
        attrs.pop("data_scale", None)
        ax = window_patch.axis_of("time")
        out = np.moveaxis(red, 0, ax) if ax != 0 else red
        result = window_patch.new(data=out, coords=coords, attrs=attrs)
        result = result.update_attrs(d_time=s * d_sec)
        filename = get_filename(
            result.attrs["time_min"], result.attrs["time_max"]
        )
        t_w0 = time.perf_counter()
        self._write_output(result, os.path.join(folder, filename))
        self.timings["write_s"] += time.perf_counter() - t_w0
        self.rolling_windows += 1
        log_event(
            "rolling_window_emitted",
            emitted=int(m),
            window_samples=w,
            step_samples=s,
            device_s=round(t_dev, 5),
        )
