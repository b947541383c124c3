"""The device renderer and the motion against their definitions, on the CPU
at a small size."""
import numpy as np
import pytest
import torch

from slambench.scene import hall, motion


def rendered_world_hits(W, H, L, R_wc, t_wc, fx, fy, cx, cy, w, h):
    """A frozen NumPy copy of tests/rendered_world.py's RoomWorld.render
    geometry: for every pixel the face it hits (its index in the plane list,
    -1 for none), the ray parameter and the face coordinates (u, v in 0-1)."""
    us, vs = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    d_cam = np.stack([(us - cx) / fx, (vs - cy) / fy, np.ones_like(us)], -1).reshape(-1, 3)
    d = d_cam @ R_wc.T
    o = t_wc
    best_t = np.full(d.shape[0], np.inf, np.float32)
    face = np.full(d.shape[0], -1)
    uvs = np.zeros((d.shape[0], 2), np.float32)
    W2, H2 = W / 2, H / 2
    planes = [
        (2, L, 0, (0, -W2, W2), (1, -H2, H2)),
        (2, 0.0, 1, (0, -W2, W2), (1, -H2, H2)),
        (0, -W2, 2, (2, 0.0, L), (1, -H2, H2)),
        (0, W2, 3, (2, 0.0, L), (1, -H2, H2)),
        (1, H2, 4, (0, -W2, W2), (2, 0.0, L)),
        (1, -H2, 5, (0, -W2, W2), (2, 0.0, L)),
    ]
    for ax, val, tid, (ua, ulo, uhi), (va, vlo, vhi) in planes:
        dz = d[:, ax]
        with np.errstate(divide="ignore", invalid="ignore"):
            t_hit = (val - o[ax]) / dz
            pu = o[ua] + t_hit * d[:, ua]
            pv = o[va] + t_hit * d[:, va]
        ok = (np.abs(dz) > 1e-9) & (t_hit > 0.05) & (t_hit < best_t)
        ok &= (pu >= ulo) & (pu <= uhi) & (pv >= vlo) & (pv <= vhi)
        face[ok] = tid
        uvs[ok] = np.stack([(pu[ok] - ulo) / (uhi - ulo), (pv[ok] - vlo) / (vhi - vlo)], -1)
        best_t[ok] = t_hit[ok]
    return face, best_t, uvs


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11])
def test_cast_matches_rendered_world_geometry(seed):
    W, H, L = 9.0, 5.5, 30.0
    w, h, fx, fy, cx, cy = 64, 48, 40.0, 41.0, 31.5, 23.2
    R_wc, C = motion.trajectory(
        dict(speed_mps=0.8, start_z_m=3.0, sway_x=1.5, sway_x_period_s=11.0, sway_y=0.5,
             sway_y_period_s=7.3, yaw=1.2, yaw_period_s=7.0, pitch=0.3, pitch_period_s=5.1,
             roll=0.2, roll_period_s=6.7), 40, 20.0, seed)
    rays = hall.pinhole_rays(w, h, fx, fy, cx, cy, "cpu")
    planes = hall.face_planes(W, H, L)
    face, t, a, b, _ = hall.cast(planes, torch.tensor(R_wc, dtype=torch.float32),
                                 torch.tensor(C, dtype=torch.float32), rays)
    ext = [(p[2][2] - p[2][1], p[3][2] - p[3][1]) for p in planes]
    n_close = n_all = 0
    for k in range(len(C)):
        f_np, t_np, uv_np = rendered_world_hits(W, H, L, R_wc[k].astype(np.float32),
                                                C[k].astype(np.float32), fx, fy, cx, cy, w, h)
        f_t = face[k].numpy()
        same = f_t == f_np
        # a ray through an edge may pick either face by rounding
        assert same.mean() > 0.995
        m = same & (f_np >= 0)
        np.testing.assert_allclose(t[k].numpy()[m], t_np[m], rtol=1e-4, atol=1e-5)
        eu = np.array([ext[f][0] for f in f_np[m]])
        ev = np.array([ext[f][1] for f in f_np[m]])
        np.testing.assert_allclose(a[k].numpy()[m] / eu, uv_np[m, 0], atol=1e-4)
        np.testing.assert_allclose(b[k].numpy()[m] / ev, uv_np[m, 1], atol=1e-4)
        n_close += int(m.sum())
        n_all += f_np.size
    assert n_close > 0.99 * n_all


def test_depth_is_z_and_images_are_textured():
    world = hall.Hall(9.0, 5.5, 40.0, seed=5, device="cpu", texture_px=64,
                      tile_m=2.5)
    rays = hall.pinhole_rays(48, 32, 30.0, 30.0, 23.5, 15.5, "cpu")
    R = torch.eye(3)[None]
    o = torch.tensor([[0.5, -0.2, 4.0]])
    img, z = world.render(R, o, rays, 30.0)
    assert img.shape == (1, 48 * 32) and float(img.std()) > 5
    assert float(img.min()) >= 0 and float(img.max()) <= 255
    # the optical-axis pixel looks down the hall at the front wall
    centre = 15 * 48 + 23
    assert abs(float(z[0, centre]) - (40.0 - 4.0)) < 0.2
    # a camera at the same place renders the same image, a seed another one
    img2, _ = world.render(R, o, rays, 30.0)
    other = hall.Hall(9.0, 5.5, 40.0, seed=6, device="cpu", texture_px=64,
                      tile_m=2.5)
    img3, _ = other.render(R, o, rays, 30.0)
    assert torch.equal(img, img2) and not torch.equal(img, img3)
    # every tile has a texture of its own
    n = len(world.texels[:world.level_base[1]]) // 64 // 64
    assert n == int((world.grid[:, 0] * world.grid[:, 1]).sum())
    bank = world.texels[:world.level_base[1]].reshape(n, -1)
    assert len(torch.unique(bank, dim=0)) == n


def distort(x, y, dist):
    """The radial-tangential model: undistorted → distorted normalized
    coordinates."""
    k1, k2, p1, p2, k3 = dist
    r2 = x * x + y * y
    radial = 1 + r2 * (k1 + r2 * (k2 + r2 * k3))
    return (x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x),
            y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y)


def test_distorted_rays_invert_the_model():
    dist = (0.262383, -0.953104, -0.005358, 0.002628, 1.163314)  # TUM1.yaml
    fx, fy, cx, cy = 517.306408, 516.469215, 318.643040, 255.313989
    rays = hall.pinhole_rays(640, 480, fx, fy, cx, cy, "cpu", dist).double()
    xd, yd = distort(rays[:, 0], rays[:, 1], dist)
    vs, us = torch.meshgrid(torch.arange(480.0, dtype=torch.float64),
                            torch.arange(640.0, dtype=torch.float64), indexing="ij")
    # float32 rays: a thousandth of a pixel
    assert float((xd * fx + cx - us.reshape(-1)).abs().max()) < 1e-3
    assert float((yd * fy + cy - vs.reshape(-1)).abs().max()) < 1e-3


def test_every_seed_moves_alike():
    m = dict(speed_mps=0.8, start_z_m=3.0, sway_x=1.5, sway_x_period_s=11.0, sway_y=0.5,
             sway_y_period_s=7.3, yaw=0.5, yaw_period_s=7.0, pitch=0.12, pitch_period_s=5.1,
             roll=0.08, roll_period_s=6.7)
    rates = []
    for seed in (1, 2, 3, 2 ** 32 + 5):
        R, C = motion.trajectory(m, 700, 20.0, seed)
        R2, C2 = motion.trajectory(m, 700, 20.0, seed)
        assert np.array_equal(R, R2) and np.array_equal(C, C2)
        assert np.all(np.diff(C[:, 2]) > 0)  # never turns back
        rel = np.einsum("nji,njk->nik", R[:-1], R[1:])
        ang = np.degrees(np.arccos(np.clip((np.trace(rel, axis1=1, axis2=2) - 1) / 2, -1, 1)))
        rates.append(ang.mean())
        np.testing.assert_allclose(np.linalg.norm(np.diff(C, axis=0), axis=1).mean(),
                                   0.8 / 20, rtol=0.5)
    assert max(rates) / min(rates) < 1.5
    assert 0.5 < np.mean(rates) < 1.3  # degrees a frame, as the mix states
