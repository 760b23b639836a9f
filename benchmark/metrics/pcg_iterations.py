"""PCG iterations a solve: the sum of ``finalize_global(...)["cg_iterations"]``,
the mean over the traced run's measured window."""


def read(t):
    cg = t.context.get("cg_per_solve")
    if not cg:
        return None
    return sum(cg) / len(cg)
