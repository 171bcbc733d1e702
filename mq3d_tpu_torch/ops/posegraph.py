"""Pose-graph optimization: Levenberg-Marquardt with line-process weights.

Counterpart of mq3d_tpu/ops/posegraph.py (Open3D's GlobalOptimization(LM)
+ GlobalOptimizationOption, reference make_fragments.py:258-269 and
refine_fragment_poses.py:297-308): nodes are camera-to-world poses, edges
carry relative transforms T_e = X_target^-1 X_source with 6x6 information
matrices; uncertain (loop-closure) edges get Choi-Zhou-Koltun line-process
weights, and edges whose converged weight falls below
edge_prune_threshold are pruned before a re-optimization.

Residuals r_e = se3_log(X_t^-1 X_s T_e^-1) with left perturbations; the
Jacobians are exact (`torch.func.jacrev`, batched over edges with
`torch.func.vmap`) in float64 on the device (`_edge_terms`).  The normal
system (6N x 6N, N of order ten to a hundred) is assembled and solved in
host numpy, as in the JAX package.  Edges are not padded: the JAX package
pads them to a power of two only so that one compiled program serves
graphs of similar size, and padded edges carry zero weight.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch
from torch.func import jacrev, vmap

from mq3d_tpu_torch.device import resolve_device
from mq3d_tpu_torch.geometry import se3


@dataclass
class PoseGraphEdge:
    source_node_id: int
    target_node_id: int
    transformation: np.ndarray  # (4,4): X_t^-1 X_s at consistency
    information: np.ndarray = field(default_factory=lambda: np.eye(6))
    uncertain: bool = False
    confidence: float = 1.0


@dataclass
class PoseGraph:
    nodes: List[np.ndarray] = field(default_factory=list)  # (4,4) camera-to-world
    edges: List[PoseGraphEdge] = field(default_factory=list)


@dataclass
class GlobalOptimizationOption:
    max_correspondence_distance: float = 0.075
    edge_prune_threshold: float = 0.25
    preference_loop_closure: float = 1.0
    reference_node: int = 0


def _residual(xi_s, xi_t, X_s, X_t, T_inv):
    Xs = se3.se3_exp(xi_s) @ X_s
    Xt = se3.se3_exp(xi_t) @ X_t
    return se3.se3_log(se3.se3_inverse(Xt) @ Xs @ T_inv)


def _one_edge(xi_s, xi_t, X_s, X_t, T_inv):
    r = _residual(xi_s, xi_t, X_s, X_t, T_inv)
    Js = jacrev(_residual, argnums=0)(xi_s, xi_t, X_s, X_t, T_inv)
    Jt = jacrev(_residual, argnums=1)(xi_s, xi_t, X_s, X_t, T_inv)
    return r, Js, Jt


def _edge_terms(X_s, X_t, T_inv):
    """Batched residuals and Jacobians at xi = 0.

    X_s, X_t, T_inv: (E, 4, 4) float64 tensors on one device.  Returns r
    (E, 6), J_s (E, 6, 6), J_t (E, 6, 6)."""
    zero = torch.zeros((X_s.shape[0], 6), dtype=X_s.dtype, device=X_s.device)
    return vmap(_one_edge)(zero, zero, X_s, X_t, T_inv)


def global_optimization(
    pose_graph: PoseGraph,
    option: Optional[GlobalOptimizationOption] = None,
    max_iteration: int = 100,
    rel_tol: float = 1e-9,
    device="cuda",
) -> PoseGraph:
    """In-place LM optimization of node poses (reference node fixed); the
    edge terms are computed on `device`, once per LM trial."""
    option = option or GlobalOptimizationOption()
    dev = resolve_device(device)
    n = len(pose_graph.nodes)
    if n == 0 or len(pose_graph.edges) == 0:
        return pose_graph

    X = np.stack([np.asarray(p, np.float64) for p in pose_graph.nodes])

    def run(edges, X):
        if not edges:
            return X, np.zeros(0)
        src = np.asarray([ed.source_node_id for ed in edges], np.int64)
        tgt = np.asarray([ed.target_node_id for ed in edges], np.int64)
        T_inv = torch.from_numpy(np.stack(
            [np.linalg.inv(np.asarray(ed.transformation, np.float64)) for ed in edges])).to(dev)
        Lam = np.stack([np.asarray(ed.information, np.float64) for ed in edges])
        unc = np.asarray([ed.uncertain for ed in edges], bool)
        mu = option.preference_loop_closure
        weights = np.ones(len(edges))

        def terms(Xc):
            r, Js, Jt = _edge_terms(torch.from_numpy(Xc[src]).to(dev),
                                    torch.from_numpy(Xc[tgt]).to(dev), T_inv)
            return r.cpu().numpy(), Js.cpu().numpy(), Jt.cpu().numpy()

        def quad_at(Xc):
            r = terms(Xc)[0]
            return np.einsum("ei,eij,ej->e", r, Lam, r)

        def lm_inner(X, weights, iters):
            """LM to convergence with fixed line-process weights."""
            lam_lm = 1e-6
            cost = float(np.sum(weights * quad_at(X)))
            for _ in range(iters):
                r, Js, Jt = terms(X)
                WL = Lam * weights[:, None, None]
                H = np.zeros((n, 6, n, 6))
                b = np.zeros((n, 6))
                Hss = np.einsum("eai,eab,ebj->eij", Js, WL, Js)
                Htt = np.einsum("eai,eab,ebj->eij", Jt, WL, Jt)
                Hst = np.einsum("eai,eab,ebj->eij", Js, WL, Jt)
                bs = np.einsum("eai,eab,eb->ei", Js, WL, r)
                bt = np.einsum("eai,eab,eb->ei", Jt, WL, r)
                np.add.at(H, (src, slice(None), src, slice(None)), Hss)
                np.add.at(H, (tgt, slice(None), tgt, slice(None)), Htt)
                np.add.at(H, (src, slice(None), tgt, slice(None)), Hst)
                np.add.at(H, (tgt, slice(None), src, slice(None)), np.swapaxes(Hst, -1, -2))
                np.add.at(b, src, bs)
                np.add.at(b, tgt, bt)

                Hd = H.reshape(6 * n, 6 * n)
                bd = b.reshape(6 * n)
                fix = np.arange(option.reference_node * 6, option.reference_node * 6 + 6)
                Hd[fix, :] = 0.0
                Hd[:, fix] = 0.0
                Hd[fix, fix] = 1.0
                bd[fix] = 0.0

                improved = False
                for _ in range(8):
                    Hlm = Hd + lam_lm * np.diag(np.maximum(np.diag(Hd), 1e-12))
                    try:
                        dx = np.linalg.solve(Hlm, -bd)
                    except np.linalg.LinAlgError:
                        lam_lm *= 10
                        continue
                    X_new = se3.se3_exp(dx.reshape(n, 6)) @ X
                    cost2 = float(np.sum(weights * quad_at(X_new)))
                    if np.isfinite(cost2) and cost2 < cost:
                        improved = True
                        lam_lm = max(lam_lm / 3, 1e-12)
                        X = X_new
                        new_cost = cost2
                        break
                    lam_lm *= 10
                if not improved:
                    break
                converged = abs(cost - new_cost) < rel_tol * max(cost, 1e-12)
                cost = new_cost
                if converged:
                    break
            return X, cost

        # Outer line-process rounds (Open3D: optimize, re-estimate l, repeat).
        for _ in range(5 if unc.any() else 1):
            X, _ = lm_inner(X, weights, max_iteration)
            new_weights = np.where(unc, (mu / (mu + quad_at(X))) ** 2, 1.0)
            done = np.allclose(new_weights, weights, atol=1e-4)
            weights = new_weights
            if done:
                break
        return X, weights

    X, w_final = run(pose_graph.edges, X)

    # Prune uncertain edges with a low converged line-process weight, then
    # optimize again (Open3D's CreatePoseGraphWithoutInvalidEdges).
    kept = [ed for ed, w in zip(pose_graph.edges, w_final)
            if not ed.uncertain or w >= option.edge_prune_threshold]
    if len(kept) < len(pose_graph.edges):
        print(f"[Info] Pose graph pruning: dropped "
              f"{len(pose_graph.edges) - len(kept)} uncertain edge(s)")
        X, _ = run(kept, X)
        pose_graph.edges = kept

    pose_graph.nodes = [X[i] for i in range(n)]
    return pose_graph
