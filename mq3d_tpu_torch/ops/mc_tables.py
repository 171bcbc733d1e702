"""Marching-cubes lookup tables, generated from first principles (the port's
own copy of mq3d_tpu/ops/mc_tables.py; numpy only).

Rather than vendoring the classic 256-entry triangle table, we derive it:
for each of the 256 corner-sign configurations, iso-contour loops are traced
by pairing the crossing edges on each cube face and walking edge -> face ->
paired edge until closure, then fan-triangulated.  Ambiguous faces (two
diagonal inside corners) are resolved by always separating the inside
corners — a rule that depends only on the shared face's corner signs, so
adjacent cells make consistent choices and the extracted surface is
crack-free.

Corner numbering (standard MC):        Edge numbering:
    4 ------ 5        y  z                e0:0-1  e1:1-2  e2:2-3  e3:3-0
   /|       /|        | /                 e4:4-5  e5:5-6  e6:6-7  e7:7-4
  7 ------ 6 |        |/                  e8:0-4  e9:1-5  e10:2-6 e11:3-7
  | 0 -----| 1        +--- x
  |/       |/
  3 ------ 2
corners: 0:(0,0,0) 1:(1,0,0) 2:(1,1,0) 3:(0,1,0)
         4:(0,0,1) 5:(1,0,1) 6:(1,1,1) 7:(0,1,1)

A corner is "inside" (bit set) when its scalar value is negative, matching
the TSDF convention (negative = behind the surface).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

CORNERS = np.array(
    [
        [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
    ],
    dtype=np.int32,
)

EDGES = np.array(
    [
        [0, 1], [1, 2], [2, 3], [3, 0],
        [4, 5], [5, 6], [6, 7], [7, 4],
        [0, 4], [1, 5], [2, 6], [3, 7],
    ],
    dtype=np.int32,
)

# Six faces as cyclically ordered corner quadruples.
FACES = [
    (0, 1, 2, 3),  # z = 0
    (4, 5, 6, 7),  # z = 1
    (0, 1, 5, 4),  # y = 0
    (3, 2, 6, 7),  # y = 1
    (0, 3, 7, 4),  # x = 0
    (1, 2, 6, 5),  # x = 1
]

_EDGE_OF_PAIR = {}
for _ei, (_a, _b) in enumerate(EDGES):
    _EDGE_OF_PAIR[(int(_a), int(_b))] = _ei
    _EDGE_OF_PAIR[(int(_b), int(_a))] = _ei

# faces adjacent to each edge
_EDGE_FACES = {e: [] for e in range(12)}
for _fi, _f in enumerate(FACES):
    for _k in range(4):
        _e = _EDGE_OF_PAIR[(_f[_k], _f[(_k + 1) % 4])]
        _EDGE_FACES[_e].append(_fi)


def _face_pairing(config: int, face: tuple) -> dict:
    """Pair the crossing edges of one face for a given corner config.

    Returns {edge_index: paired_edge_index}.  On an ambiguous face (4
    crossings) insides are separated: each inside corner keeps its own pair
    of adjacent crossing edges.
    """
    inside = [(config >> c) & 1 for c in face]
    cross = [
        _EDGE_OF_PAIR[(face[k], face[(k + 1) % 4])]
        for k in range(4)
        if inside[k] != inside[(k + 1) % 4]
    ]
    if len(cross) == 0:
        return {}
    if len(cross) == 2:
        return {cross[0]: cross[1], cross[1]: cross[0]}
    # 4 crossings: corners alternate in/out.  Pair each inside corner's two
    # incident crossing edges together ("separate insides").
    pairing = {}
    for k in range(4):
        if inside[k]:
            e_prev = _EDGE_OF_PAIR[(face[(k + 3) % 4], face[k])]
            e_next = _EDGE_OF_PAIR[(face[k], face[(k + 1) % 4])]
            pairing[e_prev] = e_next
            pairing[e_next] = e_prev
    return pairing


def _trace_loops(config: int):
    """All closed iso-contour loops (lists of edge indices) for a config."""
    crossing = [
        e for e in range(12)
        if ((config >> EDGES[e, 0]) & 1) != ((config >> EDGES[e, 1]) & 1)
    ]
    pairings = [_face_pairing(config, f) for f in FACES]

    loops = []
    visited = set()
    for start in crossing:
        if start in visited:
            continue
        # Walk: enter the edge from one of its faces, leave via the other.
        loop = [start]
        visited.add(start)
        face = _EDGE_FACES[start][0]
        edge = start
        while True:
            nxt = pairings[face][edge]
            f0, f1 = _EDGE_FACES[nxt]
            face = f1 if f0 == face else f0
            if nxt == start:
                break
            loop.append(nxt)
            visited.add(nxt)
            edge = nxt
        loops.append(loop)
    return loops


def _edge_midpoint(e: int) -> np.ndarray:
    return (CORNERS[EDGES[e, 0]] + CORNERS[EDGES[e, 1]]) / 2.0


def _orient_loop(config: int, loop: list) -> list:
    """Wind the loop so fan triangles face the outside (positive) region."""
    pts = np.array([_edge_midpoint(e) for e in loop])
    # Newell's method normal.
    n = np.zeros(3)
    for i in range(len(pts)):
        p, q = pts[i], pts[(i + 1) % len(pts)]
        n += np.cross(p, q)
    # Outward direction: from inside corners toward outside corners.
    g = np.zeros(3)
    for c in range(8):
        sign = -1.0 if (config >> c) & 1 else 1.0
        g += sign * (CORNERS[c] - 0.5)
    if np.dot(n, g) < 0:
        return loop[::-1]
    return loop


@lru_cache(maxsize=1)
def build_tables():
    """Returns (tri_table (256, 16) int32 edge ids padded with -1,
                edge_table (256,) int32 bitmask of crossing edges)."""
    tri_table = np.full((256, 16), -1, dtype=np.int32)
    edge_table = np.zeros(256, dtype=np.int32)
    for config in range(256):
        tris = []
        for loop in _trace_loops(config):
            loop = _orient_loop(config, loop)
            for k in range(1, len(loop) - 1):
                tris += [loop[0], loop[k], loop[k + 1]]
        tri_table[config, : len(tris)] = tris
        mask = 0
        for e in range(12):
            if ((config >> EDGES[e, 0]) & 1) != ((config >> EDGES[e, 1]) & 1):
                mask |= 1 << e
        edge_table[config] = mask
    return tri_table, edge_table


# Per-edge metadata for vectorized extraction:
# EDGE_OWNER_AXIS[e] — for an edge parallel to axis a starting at corner v0,
# the owning voxel is the cube-local corner v0 and the axis index.
EDGE_AXIS = np.array([EDGES[e, 1] - EDGES[e, 0] for e in range(12)])


def edge_owner() -> np.ndarray:
    """(12, 4) table: for each cube edge, (dx, dy, dz, axis) of the lattice
    edge it lies on: the edge starts at cube-corner offset (dx,dy,dz) and runs
    along `axis`.  Used to assign globally unique vertex ids so shared edges
    between neighboring cubes weld automatically."""
    out = np.zeros((12, 4), dtype=np.int32)
    for e in range(12):
        a, b = EDGES[e]
        ca, cb = CORNERS[a], CORNERS[b]
        d = cb - ca
        axis = int(np.nonzero(d)[0][0])
        start = ca if d[axis] > 0 else cb
        out[e, :3] = start
        out[e, 3] = axis
    return out
