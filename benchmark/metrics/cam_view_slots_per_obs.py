"""Slots of the camera-major view that kernel B6 walks a PCG iteration,
over the real observations: the program's own counters (``solve_global``'s
``stats``: ``cam_slots`` and ``obs``) of the traced run's solves. 1 is no
padding; one row count for every camera pads a photo collection's view by
the busiest camera's share, camera tiers by at most 2."""


def read(t):
    c = t.context
    if not (c.get("cam_slots") and c.get("obs")):
        return None
    return c["cam_slots"] / c["obs"]
