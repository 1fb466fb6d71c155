"""Work of one coloured sweep of one chain, counted from the code alone.

A proposal's change of energy needs only its check's own qubits at two bits
a qubit: two 32-bit popcounts with equal betas (the errors on the support
before and after), four with per-Pauli betas, per 32-bit word its support
fills.  Each chain draws one Philox block per four checks of a colour.
"""

from __future__ import annotations

from ..reference.codes import Code

# 64-bit words per bit plane of the kernels' register forms
KERNEL_WORDS = (1, 2, 3, 4, 6, 8, 12, 16)


def popc_per_sweep(code: Code, equal_betas: bool) -> int:
    words = -(-2 * (code.stab_ops != 0).sum(axis=1) // 32)
    return (2 if equal_betas else 4) * int(words.sum())


def philox_blocks_per_sweep(code: Code) -> int:
    return sum(-(-len(c) // 4) for c in code.colors)


def plane_words(nq: int) -> int:
    need = -(-nq // 64)
    return next((nw for nw in KERNEL_WORDS if nw >= need), need)
