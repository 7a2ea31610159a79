"""Share of the window's MLA layer decodes that ran the absorbed decode
kernel (%): 100 x the port's counter ``attention.mla_decodes{path=kernel}``
over ``attention.mla_decodes`` (a replayed step counts its layers' decodes
too).  Nothing is read where the program counts none."""


def read(run):
    total = run.counter("attention.mla_decodes")
    if total <= 0:
        return None
    return 100.0 * run.counter("attention.mla_decodes{path=kernel}") / total
