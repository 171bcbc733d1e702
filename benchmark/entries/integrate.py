"""Step 3's passes: the session's frames, both sides in sequence (the
sequence of `integrate_multi`, which spans the side boundary), fused into
one volume in chunks of `depth_integration.frames_per_batch` frames, each
chunk through `TSDFVolume.integrate` with host numpy arrays in, as
`integrate_multi`'s `run_all` calls it: the chunk's bytes cross to the card
as in a session.  The frames are the benchmark's own (reference/integrate.py
::inputs: depth filtered by the plain step 1, kept in host memory), so the
npz loads of the pipeline are left out: they are host disk work.

One step is one chunk; a pass is the whole sequence, into a volume reset
before its first chunk.  At the end of every pass the volume's counters of
dropped work are read: a pass that dropped a block allocation or a block's
chunk raises, and the run ends with no result, since it did less work than
the cell measures.  The check compares the last pass of the run, completed
after the window closed.
"""

from __future__ import annotations

import sys
import time

import torch

from benchmark.core import setting
from benchmark.reference.integrate import inputs, settings
from mq3d_tpu_torch.config.configs import IntegrationConfig
from mq3d_tpu_torch.ops.tsdf import TSDFVolume
from mq3d_tpu_torch.recon.integrate import tsdf_config_from_integration

# On a host without the card a production volume takes GiBs and minutes a
# chunk: runs there (the tests) cut the volume.
CPU_TABLE_BYTES = 256 << 20
_KNOBS = ("frames_per_batch", "alloc_pixel_stride", "grid_dim", "chunk_active_capacity",
          "integrate_tile")


def volume_config(config: dict):
    """The program's TSDF settings for the configuration's step 3."""
    di = dict(config["reconstruction"]["depth_integration"])
    for k in _KNOBS:
        di[k] = setting(config, f"reconstruction.depth_integration.{k}")
    return tsdf_config_from_integration(IntegrationConfig(**di))


class Entry:
    unit = "frames"
    trace_steps = 8  # chunks profiled in a traced run

    def __init__(self, session, config: dict, device, seed: int):
        cfg = volume_config(config)
        dev = torch.device(device)
        table_bytes = 2 * 4 * cfg.block_count * cfg.r3
        if dev.type != "cuda" and table_bytes > CPU_TABLE_BYTES:
            raise ValueError(f"a volume of {table_bytes / 2**30:.2f} GiB of voxel tables is for "
                             f"the card; on {dev} cut block_count and voxel_size first")
        # The inputs are the benchmark's: its plain step 1 filters the
        # frames.  Its seconds are on stderr, as part of set-up; its card
        # memory is freed and left out of the run's peak, which is the
        # program's from here on (the session's frames stay resident).
        t = time.perf_counter()
        self.inputs = inputs(session, config, dev)
        print(f"integrate inputs_s {time.perf_counter() - t!r}", file=sys.stderr)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        n = len(self.inputs["depth"])
        chunk = settings(config)["chunk"]
        self.chunks = [(c0, min(c0 + chunk, n)) for c0 in range(0, n, chunk)]
        self.vol = TSDFVolume(cfg, device=dev)
        self.next_chunk = 0
        self.passes = 0
        # Each pass's host seconds and the process's CPU seconds in it (on
        # stderr): a step-3 pass keeps one host core busy, so a pass that
        # takes longer on the same work shows a slower host.
        self.pass_s, self.pass_cpu_s = [], []
        self.result = None

    def _integrate(self, c0: int, c1: int) -> int:
        a = self.inputs
        valid = a["valid"][c0:c1]
        if valid.any():
            self.vol.integrate(a["depth"][c0:c1], a["K"][c0:c1], a["T_wc"][c0:c1], valid)
        return int(valid.sum())

    def warm(self) -> None:
        self._integrate(*self.chunks[0])

    def step(self) -> int:
        c0, c1 = self.chunks[self.next_chunk]
        if self.next_chunk == 0:
            self.vol.reset()
            self.t_pass = (time.perf_counter(), time.process_time())
        n = self._integrate(c0, c1)
        a = self.inputs
        self.last = {"frames": (c0, c1), "depth": a["depth"][c0:c1], "K": a["K"][c0:c1],
                     "T_wc": a["T_wc"][c0:c1], "valid": a["valid"][c0:c1]}
        self.next_chunk = (self.next_chunk + 1) % len(self.chunks)
        if self.next_chunk == 0:
            self._end_pass()
        return n

    def _end_pass(self) -> None:
        t0, c0 = self.t_pass
        self.pass_s.append(time.perf_counter() - t0)
        self.pass_cpu_s.append(time.process_time() - c0)
        self.passes += 1
        st = self.vol.state
        if st.overflow or st.dropped_active:
            raise RuntimeError(f"pass {self.passes}: the volume dropped {st.overflow} block "
                               f"allocations and {st.dropped_active} block-chunk integrations")

    def finish(self) -> None:
        """Completes the pass the window ended in (a whole pass where it
        closed on a pass boundary), then copies the pass's active blocks to
        the host."""
        self.step()
        while self.next_chunk != 0:
            self.step()
        st = self.vol.state
        n = st.n_active
        self.result = {"coords": st.block_coords[:n].cpu().numpy(),
                       "tsdf": st.tsdf[:n].cpu().numpy(),
                       "weight": st.weight[:n].cpu().numpy()}
        print(f"integrate passes {self.passes} pass_s {self.pass_s!r} cpu_s {self.pass_cpu_s!r} "
              f"blocks {n} overflow {st.overflow} dropped_active {st.dropped_active}",
              file=sys.stderr)

    def outputs(self) -> dict:
        return dict(self.result, inputs=self.inputs)

    def free(self) -> None:
        self.vol = None
        self.result = None
