"""The plain reference against brute force at tiny sizes."""

import itertools
import math

import numpy as np
import pytest
import torch

from portbench.reference import carve, edt, fusion


def _walk_scalar(counts, res, o, p, max_range):
    """One ray by the reference library's definition, one voxel at a time
    in float32 scalars: the voxels passed before the end voxel, and the
    end voxel's mark."""
    f = np.float32
    o = o.astype(f)
    ray = (p.astype(f) - o).astype(f)
    length = f(np.sqrt(np.float64(ray.astype(np.float64) ** 2).sum()))
    clipped = length > f(max_range)
    end = (o + ray * (f(max_range) / length)).astype(f) if clipped else \
        p.astype(f)
    res = f(res)
    cell = [int(math.floor(o[i] / res)) for i in range(3)]
    final = [int(math.floor(end[i] / res)) for i in range(3)]
    visits = []
    t0, dt = [], []
    for a in range(3):
        c = f((f(cell[a]) + f(0.5)) * res)
        if ray[a] > 0:
            t0.append(abs(f(f(c + res / f(2)) - o[a]) / ray[a]))
        elif ray[a] < 0:
            t0.append(abs(f(o[a] - f(c - res / f(2))) / ray[a]))
        else:
            t0.append(f(np.inf))
        dt.append(abs(f(res / ray[a])) if ray[a] != 0 else f(0))
    k = [0, 0, 0]
    while cell != final:
        if not all(0 <= cell[a] < counts[a] for a in range(3)):
            break
        visits.append(tuple(cell))
        ts = [f(t0[a] + f(f(k[a]) * dt[a])) for a in range(3)]
        a = min(range(3), key=lambda i: (ts[i], i))
        if cell[a] == final[a]:
            break
        cell[a] += 1 if final[a] > cell[a] else -1
        k[a] += 1
    end_in = all(0 <= final[a] < counts[a] for a in range(3))
    return visits, (tuple(final) if end_in else None), bool(clipped)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_walk_matches_scalar_walk(seed):
    rng = np.random.default_rng(seed)
    counts, res = (9, 7, 8), 0.1
    pose = np.eye(4)
    pose[:3, 3] = rng.uniform(0.05, 0.65, 3)
    # Rotate the camera, so the points go through the transform.
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    pose[:3, :3] = [[1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                     2 * (x * z + y * w)],
                    [2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                     2 * (y * z - x * w)],
                    [2 * (x * z - y * w), 2 * (y * z + x * w),
                     1 - 2 * (x * x + y * y)]]
    pose32 = torch.tensor(pose, dtype=torch.float32)
    pts = torch.tensor(rng.uniform(-1.2, 1.2, (200, 3)), dtype=torch.float32)
    free, filled = carve.carve(counts, res, pose32, pts, 0.9)
    want_free = np.zeros(counts, np.int32)
    want_filled = np.zeros(counts, np.int32)
    X = pose32.double().numpy()
    o = X[:3, 3].astype(np.float32)
    for p in pts.double().numpy():
        pw = (X[:3, :3] @ p + X[:3, 3]).astype(np.float32)
        visits, end, clipped = _walk_scalar(counts, res, o, pw, 0.9)
        for v in visits:
            want_free[v] += 1
        if end is not None:
            (want_free if clipped else want_filled)[end] += 1
    assert np.array_equal(free.numpy(), want_free)
    assert np.array_equal(filled.numpy(), want_filled)
    assert want_free.sum() > 200


def test_filter_matches_per_voxel_rule():
    rng = np.random.default_rng(4)
    shape = (3, 5, 4, 6)
    free = torch.tensor(rng.integers(0, 3, shape), dtype=torch.int32)
    filled = torch.tensor(rng.integers(0, 3, shape), dtype=torch.int32)
    occ = torch.tensor(rng.choice([0.0, 0.5, 1.0, 0.25], shape[1:]),
                       dtype=torch.float32)
    opts = {"percent_seen_free": 0.6, "outlier_points_threshold": 2,
            "num_cameras_seen_free": 2}
    got = fusion.fuse(opts, free, filled, occ)
    for idx in itertools.product(*map(range, shape[1:])):
        if occ[idx] > 0.5:
            assert got[idx] == occ[idx]
            continue
        n_filled = n_free = 0
        for c in range(shape[0]):
            fr, fi = int(free[(c,) + idx]), int(filled[(c,) + idx])
            fi = fi if fi >= 2 else 0
            if fr and fi:
                seen = "free" if fr / (fr + fi) >= 0.6 else "filled"
            else:
                seen = "free" if fr else ("filled" if fi else "unknown")
            n_filled += seen == "filled"
            n_free += seen == "free"
        want = 1.0 if n_filled else (0.0 if n_free >= 2 else 0.5)
        assert float(got[idx]) == want


@pytest.mark.parametrize("seed,shape", [(0, (6, 7, 5)), (1, (9, 4, 8)),
                                        (2, (5, 5, 5))])
def test_edt_matches_brute_force(seed, shape):
    rng = np.random.default_rng(seed)
    mask = rng.random(shape) < 0.08
    mask[0, 0, 0] = True
    got = edt.squared_distance(torch.tensor(mask)).numpy()
    pts = np.argwhere(mask)
    grid = np.stack(np.meshgrid(*map(np.arange, shape), indexing="ij"),
                    axis=-1).reshape(-1, 1, 3)
    want = ((grid - pts[None]) ** 2).sum(-1).min(1).reshape(shape)
    assert np.array_equal(got, want.astype(np.float32))


def test_edt_of_empty_mask_is_inf_and_signed_field():
    assert torch.isinf(edt.squared_distance(
        torch.zeros((3, 4, 5), dtype=torch.bool))).all()
    mask = torch.zeros((5, 5, 5), dtype=torch.bool)
    mask[2, 2, 2] = True
    sdf = edt.signed_distance(mask, 0.5)
    assert float(sdf[2, 2, 2]) == -0.5
    assert float(sdf[2, 2, 4]) == 1.0
    assert float(sdf[0, 0, 0]) == np.float32(np.sqrt(12.0)) * np.float32(0.5)


def test_control_precision_differs():
    rng = np.random.default_rng(7)
    mask = torch.tensor(rng.random((40, 40, 40)) < 0.001)
    mask[0, 0, 0] = True
    f32 = edt.signed_distance(mask, 0.01)
    bf16 = edt.signed_distance(mask, 0.01, dtype=torch.bfloat16)
    assert int((f32 != bf16).sum()) > 100
