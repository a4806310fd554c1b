"""The scene and depth generator repeats exactly from a seed, and every
seed gives the same views in another order."""

import numpy as np
import torch

from portbench import scenes
from portbench.tests.conftest import small_config


def _clouds(cfg, seed):
    scene = scenes.make_scene(cfg, "cpu")
    poses = scenes.camera_poses(cfg, seed)
    return poses, scenes.depth_clouds(cfg, scene, poses, seed, "cpu")


def test_repeats_from_a_seed():
    cfg = small_config("tum_kinect_512")
    seed = 2 ** 31 + 12345
    p1, c1 = _clouds(cfg, seed)
    p2, c2 = _clouds(cfg, seed)
    assert np.array_equal(p1, p2)
    assert torch.equal(c1, c2)
    p3, c3 = _clouds(cfg, seed + 1)
    assert not torch.equal(c1, c3)


def test_seeds_share_the_views_without_jitter():
    cfg = small_config("tum_kinect_512")
    cfg["path"].update(jitter_m=0.0, jitter_deg=0.0)
    a = scenes.camera_poses(cfg, 11)
    b = scenes.camera_poses(cfg, 2 ** 40 + 3)
    key = lambda p: sorted(map(tuple, np.round(p[:, 0, :3, 3], 9)))  # noqa
    assert key(a) == key(b)


def test_room_is_shared_by_configs_and_rays_hit_inside():
    for name in ("tum_kinect_512", "pair_kinect_512"):
        cfg = small_config(name)
        scene = scenes.make_scene(cfg, "cpu")
        assert 8 <= scene.boxes.shape[0] <= 12
        assert scene.spheres.shape[0] == 6
        poses, clouds = _clouds(cfg, 5)
        assert torch.isfinite(clouds).all()
        # Depth along the optical axis lies inside the room's diagonal.
        z = clouds[..., 2]
        assert float(z.min()) > 0.05 and float(z.max()) < 7.0


def test_pair_stands_still_in_the_examples_layout():
    """Two level cameras 2 m from the room's center, one on -x looking
    along +x, one on -y looking along +y, at every pose and seed."""
    cfg = small_config("pair_kinect_512")
    a = scenes.camera_poses(cfg, 11)
    b = scenes.camera_poses(cfg, 2 ** 40 + 3)
    assert np.array_equal(a, b) and np.array_equal(a, a[:1].repeat(8, 0))
    center = (np.array(cfg["room"]["lo"]) + np.array(cfg["room"]["hi"])) / 2
    for c, axis in ((0, 0), (1, 1)):
        forward = a[0, c, :3, 2]
        assert np.allclose(forward, np.eye(3)[axis], atol=1e-12)
        offset = a[0, c, :3, 3] - center
        assert np.isclose(offset[axis], -2.0) and np.isclose(
            offset[1 - axis], 0.0)


def test_point_lies_on_the_hit_surface_before_noise():
    cfg = small_config("tum_kinect_512")
    cfg["noise"].update(a=0.0, b=0.0)
    scene = scenes.make_scene(cfg, "cpu")
    poses = scenes.camera_poses(cfg, 3)
    pts = scenes.depth_clouds(cfg, scene, poses, 3, "cpu")[0, 0].double()
    X = torch.tensor(poses[0, 0])
    world = pts @ X[:3, :3].T + X[:3, 3]
    o = X[:3, 3].expand_as(world)
    d = world - o
    t = d.norm(dim=-1)
    again = scenes.ray_hits(scene, o, d / t[:, None])
    assert torch.allclose(again, t, atol=1e-4)

