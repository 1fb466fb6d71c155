"""The XZZX code, built again from its definition for the plain reference.

A frozen, self-contained statement of the XZZX code (upstream
``src/xzzx_model.py``): a d x d lattice of qubits (odd d, nq = d^2), a check
on every 2 x 2 block of the bulk acting X, Z, Z, X on its qubits (top left,
bottom left, top right, bottom right), and half checks of two qubits on
every other pair of each border (Z X on the top and left, X Z on the right
and bottom).  The checks are listed in the decoders' order (the bulk row by
row, then the half checks border by border for each pair index) and
coloured greedily over the qubits they act on (``codes._coloring``); a half
check's table row is padded with qubit 0 and the identity.

Classes: the upstream reads two parities, ``x`` over the first row (the X
component at even columns, the Z component at odd ones) and ``z`` over the
first column (the Z component at even rows, the X component at odd ones),
and numbers the classes (x, z) = (0, 0), (1, 0), (1, 1), (0, 1) as 0 to 3.
Class index bit 0 is therefore ``x ^ z`` and bit 1 is ``z``: the class rows
below hold those two parities, so ``window.class_of`` and
``inputs.true_classes`` read the class index the decoders return.

The top rung's logical draw is X on the anti-diagonal and Z on the main
diagonal, one position each (positions are drawn and ignored), an op with
an X part for ops 1 and 2 and a Z part for ops 2 and 3.
"""

from __future__ import annotations

import functools

import numpy as np

from .codes import Code, Draw, _coloring, class_bits_np

X, Z = 1, 3


def checks(d: int):
    """[(qubits, ops)] of every check, in the decoders' order."""
    def q(r: int, c: int) -> int:
        return r * d + c

    out = []
    for r in range(d - 1):
        for c in range(d - 1):
            out.append(([q(r, c), q(r + 1, c), q(r, c + 1), q(r + 1, c + 1)],
                        [X, Z, Z, X]))
    for i in range((d - 1) // 2):
        out.append(([q(0, 2 * i + 1), q(0, 2 * i + 2)], [Z, X]))  # top
        out.append(([q(2 * i + 1, d - 1), q(2 * i + 2, d - 1)], [X, Z]))  # right
        out.append(([q(d - 1, 2 * i), q(d - 1, 2 * i + 1)], [X, Z]))  # bottom
        out.append(([q(2 * i, 0), q(2 * i + 1, 0)], [Z, X]))  # left
    return out


@functools.lru_cache(maxsize=None)
def xzzx(d: int) -> Code:
    if d % 2 == 0:
        raise ValueError("the XZZX code is defined at odd d")
    nq = d * d
    rows = checks(d)
    qubits = np.zeros((len(rows), 4), np.int64)
    ops = np.zeros((len(rows), 4), np.uint8)
    masks = np.zeros((len(rows), nq), np.uint8)
    for s, (qs, os_) in enumerate(rows):
        qubits[s, :len(qs)] = qs
        ops[s, :len(os_)] = os_
        masks[s, qs] ^= np.asarray(os_, np.uint8)

    # first-row parity x and first-column parity z, on the X- and
    # Z-component planes; class bit 0 = x ^ z, bit 1 = z
    xa, xb, za, zb = (np.zeros(nq, np.uint8) for _ in range(4))
    for i in range(d):
        (xa if i % 2 == 0 else xb)[i] = 1  # (0, i)
        (zb if i % 2 == 0 else za)[i * d] = 1  # (i, 0)
    class_a = np.stack([xa ^ za, za])
    class_b = np.stack([xb ^ zb, zb])

    lut = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.uint8)
    xm = np.zeros((1, nq), np.uint8)
    zm = np.zeros((1, nq), np.uint8)
    for i in range(d):
        xm[0, i * d + d - 1 - i] = X
        zm[0, i * d + i] = Z
    draws = (Draw(xm, zm, lut),)

    # one mask per change of class index, the first of the subsets of the
    # two logicals to reach it
    gens = [xm[0], zm[0]]
    delta = np.zeros((4, nq), np.uint8)
    found = {0}
    for subset in range(4):
        mask = np.zeros(nq, np.uint8)
        for i in range(2):
            if subset >> i & 1:
                mask = mask ^ gens[i]
        k = int(class_bits_np(class_a, class_b, mask))
        if k not in found:
            found.add(k)
            delta[k] = mask
    if len(found) != 4:
        raise ValueError("the logicals do not reach every class")
    colors = _coloring([qs for qs, _ in rows], len(rows))
    return Code("xzzx", d, nq, 4, qubits, ops, masks, colors, class_a,
                class_b, delta, draws)
