"""``fleet_catchup``: a multi-well site catching up after a link outage.

Each replay is a fresh batched ``FleetEngine`` (one member a well) over
fresh well folders: well ``k`` holds hard links to its own files of the
pool (:func:`well_files`) when the fleet starts, the backlog the outage
left, so the backlog costs no new bytes.  Every member is a stateful
low-pass stream from its well's first sample, with the runner's
defaults (carry saved every round, flight ring on), no poll jitter and
a virtual clock (the fleet's sleep returns at once).  The members' B3
steps rendezvous in the fleet's ``BatchStepExecutor`` and run stacked
on the channel-packed block.  The fleet ends when every well has
drained; the next replay builds a new one.

After each replay every member folder's carry is checked
(:func:`portbench.harness.drivers.check_carry`), and the members'
``LFDAS_`` outputs are hard-linked into one folder, the one the check
reads: the wells' output times do not overlap, so no name collides
where each well reads its own files.  A name that does collide is
linked under a second name, so the check counts that time as written
twice.
"""

from __future__ import annotations

import os
import time

import numpy as np

from portbench.harness.drivers import Catchup, _sync, check_carry
from portbench.harness.trace import annotate


def well_files(pool, wells: int, k: int) -> list:
    """Indices of well ``k``'s files in the pool: the ``k``-th of
    ``wells`` equal runs of contiguous files."""
    per = int(pool["n_files"]) // int(wells)
    return list(range(k * per, (k + 1) * per))


class Driver(Catchup):
    def _replay(self, tag, tracing):
        from tpudas_torch.fleet import FleetEngine, StreamConfig, StreamSpec

        cfg, pool = self.cfg, self.pool
        wells = int(cfg["wells"])
        base = os.path.join(self.workdir, f"fleet_{tag}")
        specs = []
        for k in range(wells):
            idx = well_files(pool, wells, k)
            src = os.path.join(base, f"src_well{k}")
            os.makedirs(src)
            for i in idx:
                path = pool["paths"][i]
                os.link(path, os.path.join(src, os.path.basename(path)))
            start = int(pool["t0_ns"]) + idx[0] * int(pool["rows_file"]) \
                * int(pool["dt_ns"])
            specs.append(StreamSpec(
                stream_id=f"well{k}", source=src, config=StreamConfig(
                    kind="lowpass", start_time=np.datetime64(start, "ns"),
                    output_sample_interval=float(
                        cfg["output_sample_interval"]),
                    edge_buffer=float(cfg["edge_buffer"]),
                    process_patch_size=int(cfg["process_patch_size"]),
                    filter_order=int(cfg["filter_order"]),
                    engine=cfg["engine"], stateful=True,
                    poll_interval=0.0, poll_jitter=0.0)))
        root = os.path.join(base, "root")
        mark = self.probe.mark()
        t_run, walls = [0.0], []

        def on_round(_sid, _rnd, _lfp):
            walls.append(time.perf_counter() - t_run[0])

        with annotate("pb.replay", tracing):
            fleet = FleetEngine(root, specs, sleep_fn=lambda _s: None,
                                on_round=on_round, batched=True,
                                device=self.device)
            t_run[0] = time.perf_counter()
            summary = fleet.run()
            _sync(self.device)
        if summary["parked"]:
            errors = {s: summary["streams"][s]["error"]
                      for s in summary["parked"]}
            raise RuntimeError(f"replay {tag}: wells parked: {errors}")
        if summary["rounds_total"] != len(walls):
            raise RuntimeError(f"replay {tag}: {summary['rounds_total']} "
                               f"rounds, {len(walls)} round callbacks")
        out = os.path.join(base, "out")
        os.makedirs(out)
        for spec in specs:
            folder = os.path.join(root, spec.stream_id)
            check_carry(folder)
            for name in sorted(os.listdir(folder)):
                dst = os.path.join(out, name)
                if os.path.exists(dst):
                    stem, ext = os.path.splitext(name)
                    dst = os.path.join(out, f"{stem}.{spec.stream_id}{ext}")
                os.link(os.path.join(folder, name), dst)
        self.probe.check(mark, out)
        return out, walls
