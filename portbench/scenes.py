"""Seeded rooms, camera paths and Kinect depth frames, in plain PyTorch.

The generator uses no code of the port. A configuration file fixes the
deployment: the grid, the sensor (intrinsics, range, axial noise), the room
and how its furniture is drawn (``scene_seed``), and the path of the hand or
of the base. The run's seed decides only what changes from run to run with
the same work: where on the closed path the run starts, a small jitter of
each pose, and the depth noise. So every seed gives the same set of views,
in another order and with other noise.

Camera frames follow the optical convention (+z forward, +x right, +y
down); ``X_WC`` maps camera to world, the grid's origin is the world's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

Tensor = torch.Tensor


def seed_bits(seed: int) -> int:
    """A run's seed as a non-negative 63-bit integer (any int is taken)."""
    return int(seed) & ((1 << 63) - 1)


@dataclasses.dataclass(frozen=True)
class Scene:
    room_lo: Tensor   # [3] interior corner
    room_hi: Tensor   # [3]
    boxes: Tensor     # [B, 2, 3] axis-aligned (lo, hi)
    spheres: Tensor   # [S, 4] (center, radius)


def _ring_clearance(c_xy, half_xy, center_xy) -> float:
    """Distance in the floor plane from the room's center to an
    axis-aligned footprint."""
    d = np.maximum(np.abs(c_xy - center_xy) - half_xy, 0.0)
    return float(np.hypot(*d))


def make_scene(config: dict, device) -> Scene:
    """The room of ``config["room"]``: interior walls, floor and ceiling,
    boxes standing on the floor and floating spheres, placed by rejection
    from ``scene_seed`` so that none enters the camera path's keep-out ring
    (``clear_radius`` about the room's center) or leaves the room."""
    room = config["room"]
    rng = np.random.default_rng(int(room["scene_seed"]))
    lo = np.array(room["lo"], np.float64)
    hi = np.array(room["hi"], np.float64)
    center = (lo + hi) / 2.0
    clear = float(room["clear_radius"])
    n_boxes = int(rng.integers(room["boxes"][0], room["boxes"][1] + 1))
    boxes, spheres = [], []
    while len(boxes) < n_boxes:
        size = rng.uniform(room["box_size"][0], room["box_size"][1], 3)
        c = rng.uniform(lo[:2] + size[:2] / 2, hi[:2] - size[:2] / 2)
        if _ring_clearance(c, size[:2] / 2, center[:2]) < clear:
            continue
        blo = np.array([c[0] - size[0] / 2, c[1] - size[1] / 2, lo[2]])
        boxes.append([blo, blo + size])
    while len(spheres) < int(room["spheres"]):
        r = rng.uniform(room["sphere_radius"][0], room["sphere_radius"][1])
        c = rng.uniform(lo + r, hi - r)
        if _ring_clearance(c[:2], np.array([r, r]), center[:2]) < clear:
            continue
        spheres.append([*c, r])

    def t(x):
        return torch.tensor(np.asarray(x), dtype=torch.float32,
                            device=device)

    return Scene(t(lo), t(hi), t(np.array(boxes).reshape(-1, 2, 3)),
                 t(np.array(spheres).reshape(-1, 4)))


def _look(position, yaw, pitch) -> np.ndarray:
    """``X_WC`` of a camera at ``position`` looking along yaw/pitch
    (radians), with no roll."""
    f = np.array([math.cos(yaw) * math.cos(pitch),
                  math.sin(yaw) * math.cos(pitch), math.sin(pitch)])
    right = np.cross(f, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    down = np.cross(f, right)
    X = np.eye(4)
    X[:3, 0], X[:3, 1], X[:3, 2], X[:3, 3] = right, down, f, position
    return X


def camera_poses(config: dict, seed: int) -> np.ndarray:
    """``[P, C, 4, 4]`` float64 ``X_WC`` of every camera at every pose of
    the path, ``P = path["poses"]``, ``C`` the rig's cameras (1 for a
    handheld sensor). The path is a closed loop about the room's center,
    the heading turning ``yaw_turns`` times along it (1 unless given; 0
    and a radius of 0 hold the rig still); the seed rotates where it
    starts and jitters each pose by at most ``jitter_m`` and
    ``jitter_deg``. A rig camera sits ``offset_m`` along its own yaw from
    the rig's center (behind it where negative)."""
    path, room = config["path"], config["room"]
    rng = np.random.default_rng(seed_bits(seed))
    lo, hi = np.array(room["lo"]), np.array(room["hi"])
    center = (lo + hi) / 2.0
    n = int(path["poses"])
    start = int(rng.integers(n))
    jm, jd = float(path["jitter_m"]), math.radians(path["jitter_deg"])
    rigs = config.get("rig", {"cameras": [{"yaw_deg": 0.0,
                                           "pitch_deg": 0.0,
                                           "offset_m": 0.0}]})["cameras"]
    poses = np.empty((n, len(rigs), 4, 4))
    for i in range(n):
        theta = 2.0 * math.pi * ((i + start) % n) / n
        radius = path["radius_m"] + path["radius_wobble_m"] * math.sin(
            3 * theta)
        height = (path["height_m"][0] + path["height_m"][1]) / 2 + (
            path["height_m"][1] - path["height_m"][0]) / 2 * math.sin(
                2 * theta)
        pos = np.array([center[0] + radius * math.cos(theta),
                        center[1] + radius * math.sin(theta),
                        lo[2] + height]) + rng.uniform(-jm, jm, 3)
        heading = path.get("yaw_turns", 1) * theta + math.radians(
            path["yaw_offset_deg"]) + math.radians(
            path["yaw_sway_deg"]) * math.sin(2 * theta) + rng.uniform(-jd, jd)
        pitch = math.radians(path["pitch_deg"]) + math.radians(
            path["pitch_sway_deg"]) * math.sin(5 * theta) + rng.uniform(
                -jd, jd)
        for c, cam in enumerate(rigs):
            yaw = heading + math.radians(cam["yaw_deg"])
            p = pos + cam["offset_m"] * np.array(
                [math.cos(yaw), math.sin(yaw), 0.0])
            poses[i, c] = _look(p, yaw, pitch + math.radians(
                cam["pitch_deg"]))
    return poses


def pixel_directions(camera: dict, device) -> Tuple[Tensor, Tensor]:
    """Per pixel (row-major, ``[H * W]``): the camera-frame ray
    ``((u - cx) / fx, (v - cy) / fy, 1)`` and its unit direction."""
    h, w = int(camera["height"]), int(camera["width"])
    v, u = torch.meshgrid(torch.arange(h, dtype=torch.float64,
                                       device=device),
                          torch.arange(w, dtype=torch.float64,
                                       device=device), indexing="ij")
    ray = torch.stack([(u - camera["cx"]) / camera["fx"],
                       (v - camera["cy"]) / camera["fy"],
                       torch.ones_like(u)], dim=-1).reshape(-1, 3)
    return ray, ray / ray.norm(dim=-1, keepdim=True)


def ray_hits(scene: Scene, origins: Tensor, dirs: Tensor) -> Tensor:
    """Distance along unit ``dirs`` ``[..., 3]`` from ``origins`` (inside
    the room) to the first surface: the nearest of the room's interior
    faces, the boxes and the spheres. float64."""
    o, d = origins.double(), dirs.double()
    lo, hi = scene.room_lo.double(), scene.room_hi.double()
    with torch.no_grad():
        inv = 1.0 / torch.where(d == 0, torch.full_like(d, 1e-300), d)
        # Leaving the room: the nearest face in the direction of travel.
        t_room = torch.where(d > 0, (hi - o) * inv,
                             torch.where(d < 0, (lo - o) * inv,
                                         torch.full_like(d, math.inf)))
        t_best = t_room.amin(dim=-1)
        for b in scene.boxes.double():
            t1, t2 = (b[0] - o) * inv, (b[1] - o) * inv
            t_near = torch.minimum(t1, t2).amax(dim=-1)
            t_far = torch.maximum(t1, t2).amin(dim=-1)
            hit = (t_near <= t_far) & (t_near > 0)
            t_best = torch.where(hit & (t_near < t_best), t_near, t_best)
        for s in scene.spheres.double():
            oc = o - s[:3]
            b_ = (oc * d).sum(-1)
            c_ = (oc * oc).sum(-1) - s[3] * s[3]
            disc = b_ * b_ - c_
            t_s = -b_ - torch.sqrt(torch.clamp(disc, min=0.0))
            hit = (disc >= 0) & (t_s > 0)
            t_best = torch.where(hit & (t_s < t_best), t_s, t_best)
    return t_best


def kinect_sigma(noise: dict, z: Tensor) -> Tensor:
    """Axial noise of a Kinect v1 at depth ``z`` (Nguyen, Izadi & Lovell
    2012): ``a + b (z - z0)^2`` metres."""
    return noise["a"] + noise["b"] * (z - noise["z0"]) ** 2


def depth_clouds(config: dict, scene: Scene, poses: np.ndarray, seed: int,
                 device, batch: int = 8) -> Tensor:
    """``[P, C, H * W, 3]`` float32 camera-frame points of every camera at
    every pose: exact depth along the optical axis plus the sensor's axial
    noise, drawn from the seed by a generator on ``device``."""
    camera, noise = config["camera"], config["noise"]
    ray, unit = pixel_directions(camera, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_bits(seed) ^ 0x5EED)
    X = torch.tensor(poses, dtype=torch.float64, device=device)
    flat = X.reshape(-1, 4, 4)
    out = torch.empty((flat.shape[0], ray.shape[0], 3),
                      dtype=torch.float32, device=device)
    for lo in range(0, flat.shape[0], batch):
        Xb = flat[lo:lo + batch]
        dirs_w = torch.einsum("bij,nj->bni", Xb[:, :3, :3], unit)
        origins = Xb[:, None, :3, 3].expand_as(dirs_w)
        t = ray_hits(scene, origins, dirs_w)
        z = t * unit[:, 2]
        eps = torch.randn(z.shape, generator=gen, device=device,
                          dtype=torch.float32).double()
        z = z + kinect_sigma(noise, z) * eps
        out[lo:lo + batch] = (z[..., None] * ray).float()
    return out.reshape(poses.shape[0], poses.shape[1], -1, 3)

