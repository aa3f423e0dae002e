"""setup_s: process start to the first timed frame: imports, kernel
builds where the checkout has none, the scene, the system, its seeded
state, the prefix the mix hands it before the snapshot (which runs the
episodes' path, so every kernel and shape is built), and the noise takes."""


def read(r):
    return r.setup_s
