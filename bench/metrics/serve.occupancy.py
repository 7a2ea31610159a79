"""Mean share of the slots holding a live request over the window's
batched steps (%), `serve_continuous`'s own ``stats["occupancy"]``."""


def read(run):
    occ = run.stats.get("occupancy")
    return None if occ is None else 100.0 * occ
