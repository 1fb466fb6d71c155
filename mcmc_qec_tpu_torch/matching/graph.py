"""MWPM defect-graph construction and correction reconstruction.

A copy of ``mcmc_qec_tpu/matching/graph.py`` on the port's ``models`` and
``native``, so that the port imports nothing of the JAX package: both are
deterministic numpy around the same C++ matcher, and
tests/test_torch_matching.py holds every function equal to the JAX one bit
for bit.  Host-side vectorized numpy port of the reference's graph construction
(src/mwpm.py:17-373), feeding the native C++ exact matcher
(``mcmc_qec_tpu_torch.native``) instead of a blossom5 subprocess.  Also
*fixes* the reference's broken toric path (mwpm.py:61 reads a nonexistent
``current_state``; here the toric defect matrix comes from the table-driven
syndrome).

Planar layer conventions (mwpm.py:52-63, 232-316):
  layer 0: vertex defects, (d-1, d) grid, eliminated by Z chains (op 3)
  layer 1: plaquette defects, (d, d-1) grid, eliminated by X chains (op 1)
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np

from ..models import np_eq_class, np_syndrome
from ..models.base import CodeSpec
from ..models.planar import planar_defect_arrays
from ..native import mwpm_solve


def _defect_layers(spec: CodeSpec, state: np.ndarray):
    """Defect coordinate arrays per layer for planar/toric."""
    syn = np_syndrome(spec, state.reshape(-1))
    d = spec.size
    if spec.family == "planar":
        vertex, plaq = planar_defect_arrays(spec, syn)
        return [np.argwhere(vertex), np.argwhere(plaq)]
    if spec.family == "toric":
        arr = syn.reshape(2, d, d)
        return [np.argwhere(arr[0]), np.argwhere(arr[1])]
    raise ValueError("MWPM supports planar and toric codes "
                     "(mwpm.py:12 has the same restriction)")


def shortest_distance(spec: CodeSpec, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Manhattan distance; periodic wrap for toric (mwpm.py:17-31)."""
    diff = np.abs(a - b)
    if spec.family == "toric":
        diff = np.minimum(diff, spec.size - diff)
    return diff.sum(axis=-1)


@functools.lru_cache(maxsize=256)
def _triu_pairs(n: int):
    iu, iv = np.triu_indices(n, 1)
    return iu, iv


def _connect_all(n: int, offset: int):
    iu, iv = _triu_pairs(n)
    return iu + offset, iv + offset


def generate_edges(spec: CodeSpec, coords: np.ndarray, layer: int):
    """Unconstrained defect graph (mwpm.py:66-133).

    Planar: each defect gets an ancilla (border) node; ancillas are
    interconnected at weight 0; defect i connects to its ancilla at the
    distance to the nearest border.  Toric: complete graph on defects.
    Returns (edges (m,3) int64, n_nodes, ancilla_sides or None).
    """
    n = len(coords)
    su, sv = _connect_all(n, 0)
    dists = shortest_distance(spec, coords[su], coords[sv])
    if spec.family != "planar":
        edges = np.stack([su, sv, dists], axis=1).astype(np.int64)
        return edges, n, None

    size = spec.size
    border0 = coords[:, layer] + 1  # distance to top/left border
    near_far = (border0 * 2 >= size).astype(np.int64)  # 1 -> bottom/right
    border_dist = np.where(near_far == 1, size - border0, border0)

    au, av = _connect_all(n, n)  # ancilla clique, weight 0
    bu = np.arange(n)
    bv = np.arange(n) + n
    edges = np.concatenate(
        [
            np.stack([su, sv, dists], axis=1),
            np.stack([au, av, np.zeros(len(au), dtype=np.int64)], axis=1),
            np.stack([bu, bv, border_dist], axis=1),
        ],
        axis=0,
    ).astype(np.int64)
    return edges, 2 * n, near_far.astype(np.float64)


def generate_edges_constrained(spec: CodeSpec, coords: np.ndarray, layer: int,
                               parity: int):
    """Class-constrained graph (mwpm.py:136-229): ancillas are pinned to the
    *nearest* border per defect so the number of border crossings per side
    has fixed parity; ``parity == 1`` adds one extra ancilla node per side
    (enabling an odd number of crossings).  Returns
    (edges, n_nodes, ancilla_sides) where ancilla_sides[k] is the border of
    ancilla node n + k."""
    size = spec.size
    n = len(coords)
    su, sv = _connect_all(n, 0)
    dists = shortest_distance(spec, coords[su], coords[sv])
    parts = [np.stack([su, sv, dists], axis=1)]

    border0 = coords[:, layer] + 1
    nearest = (border0 * 2 > size).astype(np.int64)  # mwpm.py:160
    border_dist = np.where(nearest == 1, size - border0, border0)
    n_anc = np.bincount(nearest, minlength=2)

    if parity == 1:
        ancilla_sides = np.zeros(n + 2)
        for b in range(2):
            if n_anc[b] == 0:
                # no defect prefers border b: connect every defect to the
                # extra node of border b at the FAR border distance
                # (mwpm.py:177-188)
                extra = n + (n + 1) * b
                pu = np.arange(n)
                pv = np.full(n, extra)
                pd = size - border_dist
                parts.append(np.stack([pu, pv, pd], axis=1))
                ancilla_sides[(n + 1) * b] = b
            n_anc[b] += 1
        n_nodes = 2 * n + 2
    else:
        ancilla_sides = np.zeros(n)
        n_nodes = 2 * n

    # per-side ancilla cliques at weight 0 (mwpm.py:199-203)
    for b in range(2):
        au, av = _connect_all(int(n_anc[b]), n + b * int(n_anc[0]))
        parts.append(np.stack([au, av, np.zeros(len(au), dtype=np.int64)], axis=1))

    # defect -> nearest-border ancilla (mwpm.py:206-215), vectorized: the
    # k-th defect preferring border b gets ancilla node n + b*n_anc[0] + k
    rank = np.empty(n, dtype=np.int64)
    for b in range(2):
        idx = np.flatnonzero(nearest == b)
        rank[idx] = np.arange(len(idx))
    bu = np.arange(n, dtype=np.int64)
    bv = n + nearest * int(n_anc[0]) + rank
    ancilla_sides[bv - n] = nearest
    parts.append(np.stack([bu, bv, border_dist], axis=1))

    edges = np.concatenate(parts, axis=0).astype(np.int64)
    return edges, n_nodes, ancilla_sides


def eliminate_defect_pair(spec: CodeSpec, start: np.ndarray, end: np.ndarray,
                          layer: int) -> np.ndarray:
    """Correction chain connecting two defects along a minimal path
    (mwpm.py:232-288).  Returns a (2, d, d) Pauli mask."""
    d = spec.size
    op = (1 - layer) * 2 + 1  # layer 0 -> Z(3), layer 1 -> X(1)
    corr = np.zeros((2, d, d), dtype=np.uint8)
    top, bot = sorted([int(start[0]), int(end[0])])
    left, right = sorted([int(start[1]), int(end[1])])

    if spec.family == "planar":
        vert = [i + (1 - layer) for i in range(top, bot)]
        corr[layer, vert, int(start[1])] ^= op
        horiz = [i + layer for i in range(left, right)]
        corr[1 - layer, int(end[0]), horiz] ^= op
    else:  # toric: may wrap around the torus (mwpm.py:266-286)
        if (bot - top) * 2 > d:
            vert = list(range(0, top + layer)) + list(range(bot + layer, d))
        else:
            vert = [i + layer for i in range(top, bot)]
        corr[layer, vert, int(start[1])] ^= op
        if (right - left) * 2 > d:
            horiz = list(range(0, left + layer)) + list(range(right + layer, d))
        else:
            horiz = [i + layer for i in range(left, right)]
        corr[1 - layer, int(end[0]), horiz] ^= op
    return corr


def eliminate_border_defect(spec: CodeSpec, coord: np.ndarray, layer: int,
                            border: Optional[int] = None) -> np.ndarray:
    """Correction chain from a planar defect to a border (mwpm.py:291-316)."""
    d = spec.size
    op = (1 - layer) * 2 + 1
    if border is None:
        border = int((coord[layer] + 1) * 2 > d)
    corr = np.zeros((2, d, d), dtype=np.uint8)
    r, c = int(coord[0]), int(coord[1])
    if layer == 0:  # vertex defects connect vertically on layer 0
        if border == 0:
            corr[0, : r + 1, c] = op
        else:
            corr[0, r + 1 :, c] = op
    else:  # plaquette defects connect horizontally on layer 0
        if border == 0:
            corr[0, r, : c + 1] = op
        else:
            corr[0, r, c + 1 :] = op
    return corr


def solve_layer(spec: CodeSpec, state: np.ndarray, layer: int,
                parity: Optional[int] = None,
                rng: Optional[np.random.RandomState] = None,
                random_pairing: bool = False,
                coords: Optional[np.ndarray] = None) -> np.ndarray:
    """Match and eliminate all defects of one layer (mwpm.py:319-373).
    ``coords`` skips recomputing the syndrome when the caller already has
    the layer's defect coordinates."""
    if coords is None:
        coords = _defect_layers(spec, state)[layer]
    n = len(coords)
    corr = np.zeros((2, spec.size, spec.size), dtype=np.uint8)
    if n == 0:
        return corr

    if parity is None:
        edges, n_nodes, sides = generate_edges(spec, coords, layer)
    else:
        edges, n_nodes, sides = generate_edges_constrained(spec, coords, layer, parity)

    if random_pairing:
        pairs = _random_pairing(edges, n, rng or np.random.RandomState())
    else:
        match, _ = mwpm_solve(n_nodes, edges)
        pairs = [(u, int(match[u])) for u in range(n_nodes)
                 if match[u] > u]

    for u, v in pairs:
        if u < n and v < n:
            corr ^= eliminate_defect_pair(spec, coords[u], coords[v], layer)
        elif u < n <= v:
            border = int(sides[v - n]) if sides is not None else None
            corr ^= eliminate_border_defect(spec, coords[u], layer, border)
        elif v < n <= u:
            border = int(sides[u - n]) if sides is not None else None
            corr ^= eliminate_border_defect(spec, coords[v], layer, border)
        # ancilla-ancilla pairs need no correction
    return corr


def _random_pairing(edges: np.ndarray, n_defects: int,
                    rng: np.random.RandomState) -> List[Tuple[int, int]]:
    """Random valid pairing instead of the optimal one (mwpm.py:33-50)."""
    edges = edges[~((edges[:, 0] >= n_defects) & (edges[:, 1] >= n_defects))]
    chosen = []
    order = rng.permutation(len(edges))
    used = set()
    for i in order:
        u, v = int(edges[i, 0]), int(edges[i, 1])
        if u in used or v in used:
            continue
        chosen.append((u, v))
        used.add(u)
        used.add(v)
    return chosen


def mwpm_correction(spec: CodeSpec, state: np.ndarray,
                    random_pairing: bool = False,
                    seed: Optional[int] = None) -> np.ndarray:
    """Full MWPM correction chain for a state's syndrome (mwpm.py:408-415).
    The returned chain has the same syndrome as ``state``."""
    rng = np.random.RandomState(seed)
    corr = np.zeros((2, spec.size, spec.size), dtype=np.uint8)
    layers = _defect_layers(spec, state)
    for layer in range(2):
        corr ^= solve_layer(spec, state, layer, rng=rng,
                            random_pairing=random_pairing,
                            coords=layers[layer])
    return corr


def generate_classes(spec: CodeSpec, state: np.ndarray) -> List[np.ndarray]:
    """Four class-constrained corrections (planar; mwpm.py:417-437)."""
    assert spec.family == "planar"
    d = spec.size
    layers = _defect_layers(spec, state)
    solution_list = [[None, None], [None, None]]
    for layer in range(2):
        if len(layers[layer]) > 0:
            for parity in range(2):
                solution_list[layer][parity] = solve_layer(
                    spec, state, layer, parity, coords=layers[layer]
                )
        else:
            op = (1 - layer) * 2 + 1
            empty = np.zeros((2, d, d), dtype=np.uint8)
            logical = empty.copy()
            if layer == 0:  # Z logical: Z down column 0 of layer 0
                logical[0, :, 0] = 3
            else:  # X logical: X across row 0 of layer 0
                logical[0, 0, :] = 1
            solution_list[layer][0] = empty
            solution_list[layer][1] = logical
    out = []
    for l0 in solution_list[0]:
        for l1 in solution_list[1]:
            out.append(l0 ^ l1)
    return out


def class_sorted_mwpm(spec: CodeSpec, state: np.ndarray) -> np.ndarray:
    """(4, nq) per-class low-energy seeds, indexed by class (mwpm.py:462-475)."""
    chains = generate_classes(spec, state)
    out = np.zeros((4, spec.nq), dtype=np.uint8)
    seen = set()
    for chain in chains:
        flat = chain.reshape(-1)
        eq = int(np_eq_class(spec, flat))
        out[eq] = flat
        seen.add(eq)
    if len(seen) != 4:
        raise RuntimeError(f"class_sorted_mwpm covered only classes {seen}")
    return out


def class_sorted_mwpm_batch(spec: CodeSpec, states: np.ndarray,
                            max_workers: Optional[int] = None) -> np.ndarray:
    """(B, 4, nq) per-class seeds for a whole syndrome batch.

    The reference computes warm starts one syndrome per process
    (generate_data.py:126-129); here graph construction is vectorized and
    the batch shares one process.  Graph construction is GIL-bound
    Python/numpy (the ctypes matcher releases the GIL for the rest), so
    the thread pool only pays off on many-core hosts; on <= 2 cores it
    runs sequentially.  ``chip_smoke.py`` phase 21 prints its rate."""
    from concurrent.futures import ThreadPoolExecutor

    states = np.asarray(states)
    if len(states) == 0:
        return np.zeros((0, 4, spec.nq), np.uint8)
    import os

    workers = max_workers or (os.cpu_count() or 1)
    if len(states) <= 1 or workers <= 2:
        return np.stack([class_sorted_mwpm(spec, s) for s in states])
    with ThreadPoolExecutor(max_workers=min(workers, 32)) as ex:
        return np.stack(
            list(ex.map(lambda s: class_sorted_mwpm(spec, s), states))
        )


def regular_mwpm_batch(spec: CodeSpec, states: np.ndarray,
                       max_workers: Optional[int] = None) -> np.ndarray:
    """(B,) optimal-MWPM class per syndrome, pooled like
    ``class_sorted_mwpm_batch``."""
    from concurrent.futures import ThreadPoolExecutor

    states = np.asarray(states)
    if len(states) == 0:
        return np.zeros((0,), np.int64)
    import os

    workers = max_workers or (os.cpu_count() or 1)
    if len(states) <= 1 or workers <= 2:
        return np.array([regular_mwpm(spec, s) for s in states], np.int64)
    with ThreadPoolExecutor(max_workers=min(workers, 32)) as ex:
        return np.fromiter(
            ex.map(lambda s: regular_mwpm(spec, s), states),
            dtype=np.int64, count=len(states),
        )


def regular_mwpm(spec: CodeSpec, state: np.ndarray) -> int:
    """Class of the optimal unconstrained MWPM correction (mwpm.py:479-486)."""
    corr = mwpm_correction(spec, state)
    return int(np_eq_class(spec, corr.reshape(-1)))


def enhanced_mwpm(spec: CodeSpec, state: np.ndarray, model: str = "depolarizing",
                  p_xyz: Optional[np.ndarray] = None,
                  seed: Optional[int] = None) -> int:
    """Class-constrained MWPM with model-dependent class choice
    (mwpm.py:490-514)."""
    rng = np.random.RandomState(seed)
    sorted_classes = class_sorted_mwpm(spec, state)
    counts = np.stack(
        [
            [(c == 1).sum(), (c == 2).sum(), (c == 3).sum()]
            for c in sorted_classes
        ]
    )
    if model == "depolarizing":
        totals = counts.sum(axis=1)
        best = np.flatnonzero(totals == totals.min())
    elif model == "uncorrelated":
        weighted = counts[:, 0] + 2 * counts[:, 1] + counts[:, 2]
        best = np.flatnonzero(weighted == weighted.min())
    elif model == "biased":
        assert p_xyz is not None
        rel = (p_xyz / 3.0) / (1.0 - p_xyz)
        logp = (counts - counts[0]) @ np.log(rel)
        best = np.flatnonzero(np.isclose(logp, logp.max()))
    else:
        raise ValueError(f"unknown model {model!r}")
    return int(rng.choice(best))
