"""plan.host_pct: the share of each `run_plan` call's host-clock time
spent outside its groups' synchronized simulation (`GroupProfile`'s
``execute_s``): building points, configurations and parameters, grouping,
post-processing.  Percent, over the window's plans."""


def read(view):
    wall = sum(p.t1 - p.t0 for p in view.plans)
    if wall <= 0:
        return None
    return 100.0 * (wall - sum(p.execute_s for p in view.plans)) / wall
