"""Step 1's passes: every frame of each side as a reference frame, through
`recon/confidence.py::confidence_for_refs`, `frames_per_batch` references
per call, with each side's depth stack resident on the card as
`estimate_depth_confidences` puts it there, and each call's confidence
and valid-count maps read back to the host as that function reads them:
`.cpu().numpy()` of the whole padded batch, the arrays dropped once the
call is done with.  The per-frame npz writes of that function are left
out: they are host disk work.

One step is one call; a pass is both sides.  The arrays of the calls
that the check samples (reference/confidence.py::checked_batches) are
kept, the newest of each, in place of being dropped.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.confidence import checked_batches, refs_per_call
from mq3d_tpu_torch.recon.confidence import confidence_for_refs


class Entry:
    unit = "frames"
    trace_steps = 8  # calls profiled in a traced run

    def __init__(self, session, config: dict, device, seed: int):
        ce = config["reconstruction"]["confidence_estimation"]
        self.B = refs_per_call(config)
        self.args = dict(depth_max=float(ce["depth_max"]),
                         error_threshold=float(ce["error_threshold"]),
                         window=int(ce["target_frame_range"]))
        dev = torch.device(device)
        self.n = session.frames_per_side
        self.sides = []
        for s in range(int(session.side.max()) + 1):
            sl = session.side_slice(s)
            T_cw = session.T_cw[sl].astype(np.float32)
            T_wc = np.linalg.inv(T_cw)
            self.sides.append(dict(
                depth=session.depth[sl].to(dev).contiguous(),
                K=torch.from_numpy(np.asarray(session.K_depth[sl], np.float32)).to(dev),
                T_cw=torch.from_numpy(T_cw).to(dev),
                T_wc=torch.from_numpy(T_wc).to(dev),
                valid=torch.ones(self.n, dtype=torch.bool, device=dev)))
        self.batches = [(s, b) for s in range(len(self.sides)) for b in range(0, self.n, self.B)]
        self.kept = dict.fromkeys(checked_batches(len(self.sides), self.n, self.B, seed))
        self.next_batch = 0
        self.dev = dev

    def _call(self, s: int, b0: int) -> tuple:
        """One call and its read-back: (references, confidence, valid_count)."""
        batch = list(range(b0, min(b0 + self.B, self.n)))
        # The last batch is padded with its last frame, as the pipeline does.
        refs = np.asarray(batch + [batch[-1]] * (self.B - len(batch)), np.int64)
        d = self.sides[s]
        conf, cnt = confidence_for_refs(d["depth"], d["K"], d["T_cw"], d["T_wc"], d["valid"],
                                        torch.from_numpy(refs).to(self.dev), **self.args)
        return batch, conf.cpu().numpy(), cnt.cpu().numpy()

    def warm(self) -> None:
        self._call(0, 0)

    def step(self) -> int:
        s, b0 = self.batches[self.next_batch]
        result = self._call(s, b0)
        if (s, b0) in self.kept:
            self.kept[(s, b0)] = result
        self.last = (s, result[0])
        self.next_batch = (self.next_batch + 1) % len(self.batches)
        return len(result[0])

    def finish(self) -> None:
        """Runs on until every checked call has been made once."""
        while any(v is None for v in self.kept.values()):
            self.step()

    def outputs(self) -> dict:
        """The checked calls' maps, the padding cut off."""
        frames, conf, cnt = [], [], []
        for (s, _), (batch, c, n) in self.kept.items():
            frames.append((s, batch))
            conf.append(c[:len(batch)])
            cnt.append(n[:len(batch)])
        return {"frames": frames, "confidence": np.concatenate(conf),
                "valid_count": np.concatenate(cnt)}

    def free(self) -> None:
        self.sides = None
        self.kept = None
