"""Kernel time by the port's kernel names, from the trace's reduction."""

# device function names of the port's two kernels (csrc/*.cu, namespace mqt)
K1 = "sweep_kernel"
K2 = "ladder_window_kernel"


def seconds(rec: dict, name: str):
    """(seconds, launches) of the kernels whose name holds ``name``, or
    None when the trace shows none."""
    ks = [v for k, v in (rec.get("kernels") or {}).items() if name in k]
    if not ks:
        return None
    return sum(v[0] for v in ks), sum(v[1] for v in ks)
