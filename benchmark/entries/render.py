"""Step 6's passes: each side's colour keyframes rendered from the session's
volume through `ops/raycast.py::raycast_in_color_view`, run over a
`CameraDataset` of the side's keyframes (every `color_optimization.interval`-th
frame, seen from its frame's pose, in the OPEN3D camera frame) and
consumed to host numpy as `recon/reconstruct.py::render_color_aligned_depth`
consumes it, `color_aligned_depth_rendering.frames_per_batch` views per
render call.  The `.npy` writes of that function are left out: they are
host disk work.

Set-up builds the volume with the program: `TSDFVolume.integrate` over the
session's frames, both sides in sequence, in the configuration's chunks,
with the frames already on the card; a volume that counts a dropped block
allocation or block-chunk integration ends the run with no result.  It then
makes a second volume holding a copy of the first one's state, tensor by
tensor.  One step is one side; a pass is both sides, from one volume, and
passes alternate between the two.  The program's scene preparation is
cached on the volume's identity, so each pass pays it once, as one
session's step 6 does.

Every view is kept as read back, the newest of each; the check compares
the run's last pass, completed after the window closed, at the pixels
reference/render.py::checked_pixels draws.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark.core import setting
from benchmark.entries.integrate import CPU_TABLE_BYTES, volume_config
from benchmark.reference.render import keyframes, render_settings
from mq3d_tpu_torch.geometry import quaternion as quat
from mq3d_tpu_torch.models.datasets import CameraDataset
from mq3d_tpu_torch.models.transforms import CoordinateSystem, Transforms
from mq3d_tpu_torch.ops.raycast import raycast_in_color_view
from mq3d_tpu_torch.ops.tsdf import TSDFState, TSDFVolume


def camera_dataset(session, frames: list) -> CameraDataset:
    """The colour camera's dataset of the session's `frames`: intrinsics as
    a capture stores them (cx not flipped), camera-to-world poses in the
    OPEN3D frame."""
    n, w, h = len(frames), session.color_width, session.color_height
    K = session.K_color
    T = session.T_cw[frames]
    return CameraDataset(
        directory_relative_path="", image_file_names=np.array([f"{f}.png" for f in frames]),
        timestamps=np.asarray(frames, np.int64),
        fx=np.full(n, K[0, 0]), fy=np.full(n, K[1, 1]), cx=np.full(n, w - float(K[0, 2])),
        cy=np.full(n, K[1, 2]),
        transforms=Transforms(CoordinateSystem.OPEN3D, T[:, :3, 3].copy(),
                              np.asarray(quat.from_matrix(T[:, :3, :3]))),
        widths=np.full(n, w, np.int64), heights=np.full(n, h, np.int64))


def copy_volume(vol: TSDFVolume) -> TSDFVolume:
    """A second volume holding a copy of `vol`'s state, tensor by tensor."""
    st = vol.state
    state = TSDFState(slot_table=st.slot_table.clone(), block_coords=st.block_coords.clone(),
                      tsdf=st.tsdf.clone(), weight=st.weight.clone(), n_active=st.n_active,
                      overflow=st.overflow, dropped_active=st.dropped_active)
    return TSDFVolume(vol.cfg, state=state)


class Entry:
    unit = "frames"
    trace_steps = 4  # sides profiled in a traced run: two passes, one from each volume

    def __init__(self, session, config: dict, device, seed: int):
        cfg = volume_config(config)
        dev = torch.device(device)
        table_bytes = 2 * 4 * cfg.block_count * cfg.r3
        if dev.type != "cuda" and table_bytes > CPU_TABLE_BYTES:
            raise ValueError(f"a volume of {table_bytes / 2**30:.2f} GiB of voxel tables is for "
                             f"the card; on {dev} cut block_count and voxel_size first")
        t = time.perf_counter()
        vol = TSDFVolume(cfg, device=dev)
        K = np.asarray(session.K_depth, np.float32)
        T_wc = np.linalg.inv(session.T_cw).astype(np.float32)
        n = len(T_wc)
        chunk = int(setting(config, "reconstruction.depth_integration.frames_per_batch"))
        for c0 in range(0, n, chunk):
            c1 = min(c0 + chunk, n)
            vol.integrate(session.depth[c0:c1], K[c0:c1], T_wc[c0:c1], np.ones(c1 - c0, bool))
        st = vol.state
        if st.overflow or st.dropped_active:
            raise RuntimeError(f"the volume dropped {st.overflow} block allocations and "
                               f"{st.dropped_active} block-chunk integrations")
        self.vols = [vol, copy_volume(vol)]
        if dev.type == "cuda":
            torch.cuda.synchronize()
        print(f"render volume_s {time.perf_counter() - t!r} blocks {st.n_active}", file=sys.stderr)
        rs = render_settings(config)
        self.batch, self.u16 = rs["batch"], rs["transfer_u16"]
        self.frames = keyframes(session, config)
        self.datasets = [camera_dataset(session, f) for f in self.frames]
        self.kept = {}
        self.next_side = 0
        self.passes = 0
        # Each pass's host seconds and the process's CPU seconds in it (on
        # stderr): a pass waits on the host more than on the card.
        self.pass_s, self.pass_cpu_s = [], []

    def _render(self, vol: TSDFVolume, s: int) -> int:
        it = raycast_in_color_view(vol, self.datasets[s], frames_per_batch=self.batch,
                                   transfer_u16=self.u16)
        n = 0
        for z in it:
            self.kept[(s, n)] = z
            n += 1
        return n

    def warm(self) -> None:
        """One pass from the second volume: both sides' calls, each call
        size, and the scene preparation."""
        for s in range(len(self.datasets)):
            self._render(self.vols[1], s)

    def step(self) -> int:
        s = self.next_side
        if s == 0:
            self.t_pass = (time.perf_counter(), time.process_time())
        n = self._render(self.vols[self.passes % 2], s)
        d = self.datasets[s]
        self.last = {"side": s, "K": d.get_render_intrinsic_matrices(),
                     "T_cw": d.transforms.extrinsics_cw, "width": int(d.widths[0]),
                     "height": int(d.heights[0]), "batch": self.batch}
        self.next_side = (s + 1) % len(self.datasets)
        if self.next_side == 0:
            self.passes += 1
            self.pass_s.append(time.perf_counter() - self.t_pass[0])
            self.pass_cpu_s.append(time.process_time() - self.t_pass[1])
        return n

    def finish(self) -> None:
        """Completes the pass the window ended in (a whole pass where it
        closed on a pass boundary)."""
        self.step()
        while self.next_side != 0:
            self.step()
        print(f"render passes {self.passes} pass_s {self.pass_s!r} cpu_s {self.pass_cpu_s!r}",
              file=sys.stderr)

    def outputs(self) -> dict:
        views = sorted(self.kept)
        return {"views": views, "depth": np.stack([self.kept[v] for v in views])}

    def free(self) -> None:
        self.vols = None
        self.kept = None
