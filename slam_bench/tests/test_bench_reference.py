"""The references: the plain extractor equals the program's extraction
bit for bit on the CPU, its bf16 control does not, and the refits land on
the optimum of exact observations."""

import numpy as np
import pytest
import torch

from orb_slam_tpu_torch.frontend.orb_extractor import ORBConfig, ORBExtractor
from slam_bench import check
from slam_bench.reference import refit
from slam_bench.reference.orb import Extractor
from slam_bench.scene import SyntheticScene, lateral_trajectory


@pytest.mark.parametrize("harris", [False, True], ids=["fast", "harris"])
def test_reference_extractor_is_the_programs_bit_for_bit(harris):
    scene = SyntheticScene(n_points=800, seed=3)
    img = torch.from_numpy(scene.render_image(lateral_trajectory(3, 0.08, 0.01)[2]))
    prog = ORBExtractor(ORBConfig(score_harris=harris), 480, 640, device="cpu")(img)
    got = dict(xy=prog.xy, angle=prog.angle, octave=prog.octave,
               desc=prog.desc_i32, valid=prog.valid)
    ref = Extractor(1000, 8, 1.2, 20.0, harris, 480, 640, "cpu")(img)
    assert int(ref["valid"].sum()) > 900
    assert check.features_differ(got, ref) == 0.0
    ctl = Extractor(1000, 8, 1.2, 20.0, harris, 480, 640, "cpu", control=True)(img)
    assert check.features_differ(ctl, ref) > 0.3


def _world_points(n, rng):
    return np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                     rng.uniform(4, 12, n)], 1)


def test_pose_refit_lands_on_the_exact_pose():
    rng = np.random.default_rng(0)
    X = torch.from_numpy(_world_points(300, rng))
    K = torch.tensor([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], dtype=torch.float64)
    T = torch.eye(4, dtype=torch.float64)
    T[:3, :3] = refit.rodrigues(torch.tensor([0.02, -0.05, 0.01], dtype=torch.float64))
    T[:3, 3] = torch.tensor([0.3, -0.1, 0.2], dtype=torch.float64)
    uv = refit.project(T, X, K)
    start = T.clone()
    start[:3, 3] += torch.tensor([0.05, 0.02, -0.04], dtype=torch.float64)
    got = refit.pose_refit(start, X, uv, torch.ones(300, dtype=torch.float64), K)
    assert float(torch.linalg.norm(refit.center(got) - refit.center(T))) < 1e-9
    ctl = refit.pose_refit(start, X, uv, torch.ones(300, dtype=torch.float64), K,
                           rnd=refit.bf16)
    assert float(torch.linalg.norm(refit.center(ctl) - refit.center(T))) > 1e-4


def test_points_refit_lands_on_the_exact_points():
    rng = np.random.default_rng(1)
    X = torch.from_numpy(_world_points(50, rng))
    K = torch.tensor([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], dtype=torch.float64)
    poses = torch.eye(4, dtype=torch.float64).repeat(3, 1, 1)
    poses[:, 0, 3] = torch.tensor([0.0, -0.3, -0.6], dtype=torch.float64)
    P = poses[None].expand(50, 3, 4, 4)
    uv = refit.project(P, X[:, None, :], K)
    mask = torch.ones(50, 3, dtype=torch.bool)
    mask[::5, 2] = False
    start = X + torch.from_numpy(rng.normal(0, 0.05, X.shape))
    got, ok = refit.points_refit(start, P, uv, torch.ones(50, 3, dtype=torch.float64),
                                 mask, K)
    assert bool(ok.all())
    assert float((got - X).abs().max()) < 1e-8
