"""Plotting: lattice/error visualization and failure-rate curves.

Replaces the reference's per-code ``plot`` methods (toric_model.py:103-171,
planar_model.py:155-216, rotated_surface_model.py:133-195) and the analysis
plots of plot_uncorrelated.py:200-301 — headless-safe (Agg), no
``plt.show()`` blocking (the reference's rotated ``syndrome()``
unconditionally pops a window, rotated_surface_model.py:131).

The port's copy of ``mcmc_qec_tpu/pipeline/plot.py``.  matplotlib is
imported inside the functions, not with the module, so the pipeline runs
where matplotlib is not installed."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..models import defect_array, np_syndrome
from ..models.base import CodeSpec

def _pyplot():
    """matplotlib.pyplot on the headless Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


_PAULI_COLORS = {1: "tab:red", 2: "blueviolet", 3: "tab:blue"}
_PAULI_NAMES = {1: "X", 2: "Y", 3: "Z"}


def _rotated_defect_xy(d: int, pr: int, pc: int):
    """Plot position of a defect at plaquette (pr, pc) of the rotated/xzzx
    (d+1, d+1) defect array, in reference coordinates (qubit (r, c) at
    (c, d-1-r)).  Boundary half-stabilizer defects are nudged 0.25 toward
    the lattice interior; the nudge precedence (left edge, then top, then
    right, then bottom — corners take the first match) reproduces the
    reference's elif chain (rotated_surface_model.py:177-189,
    xzzx_model.py:129-141)."""
    x, y = pc - 0.5, d - pr - 0.5
    if pc == 0:
        x += 0.25
    elif pr == 0:
        y -= 0.25
    elif pc == d:
        x -= 0.25
    elif pr == d:
        y += 0.25
    return x, y


def _draw_rotated(spec: CodeSpec, state: np.ndarray, ax) -> None:
    """Rotated/xzzx lattice in the reference's visual conventions
    (rotated_surface_model.py:133-195, xzzx_model.py:85-147): a (d, d)
    qubit grid with semicircular boundary stabilizers on alternating edge
    pairs, errors as $X$/$Y$/$Z$ glyphs, and red flux dots at the
    (d+1, d+1) defect positions."""
    from matplotlib.patches import Arc

    from ..models import defect_array, np_syndrome

    d = spec.size
    for i in range(d):
        ax.plot([0, d - 1], [i, i], color="k", lw=1.5)
        ax.plot([i, i], [0, d - 1], color="k", lw=1.5)
    # boundary half-stabilizers: radius-1/2 arcs bulging outward over
    # alternating qubit pairs of each edge
    for i in range((d - 1) // 2):
        arcs = [
            ((1.5 + 2 * i, d - 1), 0, 180),  # top
            ((0.5 + 2 * i, 0), 180, 360),  # bottom
            ((d - 1, 0.5 + 2 * i), -90, 90),  # right
            ((0, d - 1.5 - 2 * i), 90, 270),  # left
        ]
        for center, t1, t2 in arcs:
            ax.add_patch(Arc(center, 1, 1, theta1=t1, theta2=t2,
                             color="k", lw=1.5))
    xs, ys = np.meshgrid(np.arange(d), np.arange(d))
    ax.plot(xs, ys, "o", color="k", mfc="white", ms=14, zorder=2)
    qm = state.reshape(d, d)
    for v in (1, 2, 3):
        rr, cc = np.where(qm == v)
        if len(rr):
            ax.plot(cc, d - 1 - rr, linestyle="none", color="tab:blue",
                    marker=f"${_PAULI_NAMES[v]}$", ms=9, zorder=3,
                    label=f"{_PAULI_NAMES[v]} error")
    darr = defect_array(spec, np_syndrome(spec, state.reshape(-1)))
    for pr, pc in np.argwhere(darr):
        x, y = _rotated_defect_xy(d, pr, pc)
        ax.plot(x, y, "o", color="red", ms=7, zorder=4)


def plot_state(spec: CodeSpec, state: np.ndarray, path: str,
               title: Optional[str] = None) -> None:
    """Draw the lattice, errors, and defects; save to ``path``."""
    plt = _pyplot()
    d = spec.size
    state = np.asarray(state).reshape(spec.state_shape)
    if spec.family in ("rotated", "xzzx"):
        fig, ax = plt.subplots(figsize=(6, 6))
        _draw_rotated(spec, state, ax)
        ax.set_aspect("equal")
        ax.axis("off")
        if title:
            ax.set_title(title)
        if state.any():
            ax.legend(loc="upper right", fontsize=8)
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return
    fig, ax = plt.subplots(figsize=(6, 6))
    for i in range(d):
        ax.axhline(-i, color="k", lw=0.6, alpha=0.4)
        ax.axvline(i, color="k", lw=0.6, alpha=0.4)

    def qubit_xy(idx):
        if len(spec.state_shape) == 3:
            l, r, c = np.unravel_index(idx, spec.state_shape)
            # layer 0 on vertical edges, layer 1 on horizontal edges
            return (c + 0.5 * l, -(r + 0.5 * (1 - l)))
        r, c = np.unravel_index(idx, spec.state_shape)
        return (c, -r)

    flat = state.reshape(-1)
    for idx in range(spec.nq):
        x, y = qubit_xy(idx)
        if spec.valid_mask[idx]:
            ax.plot(x, y, "o", mfc="white", mec="k", ms=10, zorder=2)
    for v in (1, 2, 3):
        pts = [qubit_xy(i) for i in np.flatnonzero(flat == v)]
        if pts:
            xs, ys = zip(*pts)
            ax.plot(xs, ys, "o", color=_PAULI_COLORS[v], ms=10,
                    label=f"{_PAULI_NAMES[v]} error", zorder=3)

    syn = np_syndrome(spec, flat)
    if spec.family == "planar":
        from ..models.planar import planar_defect_arrays

        vertex, plaq = planar_defect_arrays(spec, syn)
        defect_pts = [(c, -(r + 0.5)) for r, c in np.argwhere(vertex)]
        defect_pts += [(c + 0.5, -r) for r, c in np.argwhere(plaq)]
    else:
        darr = defect_array(spec, syn)
        defect_pts = []
        for pos in np.argwhere(darr):
            if len(pos) == 3:
                l, r, c = pos
                defect_pts.append((c + 0.5 * l, -(r + 0.5 * l)))
            else:
                r, c = pos
                defect_pts.append((c - 0.5, -(r - 0.5)))
    for x, y in defect_pts:
        ax.plot(x, y, "s", color="orange", ms=6, zorder=4)

    ax.set_aspect("equal")
    ax.axis("off")
    if title:
        ax.set_title(title)
    if any(flat):
        ax.legend(loc="upper right", fontsize=8)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_success_rates(curves: Dict[str, Dict[float, float]], path: str,
                       ylabel: str = "success rate") -> None:
    """Success/failure-rate curves vs p (plot_uncorrelated.py:200-301);
    ``curves`` maps label -> {p: rate}."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    for label, curve in curves.items():
        ps = sorted(curve)
        ax.plot(ps, [curve[p] for p in ps], "o-", label=label)
    ax.set_xlabel("physical error rate p")
    ax.set_ylabel(ylabel)
    ax.grid(alpha=0.3)
    ax.legend()
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
