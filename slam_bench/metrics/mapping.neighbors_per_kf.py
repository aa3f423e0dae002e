"""mapping.neighbors_per_kf: covisible keyframes (sharing 15 points or
more) of each new keyframe, the program's own list
(SLAMSystem._covisible_neighbors), mean over the keyframe integrations
of the traced run's window. Triangulation and fuse take the first 20."""


def read(r):
    n = r.spans.get("neighbors", [])
    return sum(n) / len(n) if n else None
