"""A ray-cast, textured box hall rendered on the device.

A PyTorch rewrite of `tests/rendered_world.py`'s `RoomWorld`: the same
axis-aligned box [-W/2, W/2] x [-H/2, H/2] x [0, L], the same six faces in
the same order, the same ray-plane intersection (a hit counts beyond 0.05 of
the ray parameter, inside the face's bounds, nearest first) and bilinear
texture sampling. What differs:

- the textures are seeded fractal noise made on the device (the recipe that
  `rendered_world.py` falls back on: uniform noise at 1/8 of the texture's
  size and +-60 noise at 1/2, both upsampled bicubically, clipped to
  0-255), and every face is cut into square tiles that each have a texture
  of their own, so nothing in a hall repeats: a patch is seen again only
  where the path brings it back into view;
- a texel footprint picks one of a few box-filtered levels of each texture,
  so far and grazing surfaces do not alias into noise a camera never sees;
- a batch of views is cast at once, and the caller may hand in its own rays
  (a distorted camera casts each pixel's undistorted ray);
- the ray parameter of a hit is also returned: the rays have camera z = 1,
  so it is the hit's depth along the optical axis.

All arithmetic is elementwise (no matrix products), so the images do not
depend on the process's TF32 setting.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

T_MIN = 0.05  # nearest accepted hit along a ray (rendered_world.py's)


def face_planes(W, H, L):
    """The six faces as (axis, value, (u axis, u lo, u hi), (v axis, v lo,
    v hi)), in rendered_world.py's order: front, back, left, right, floor,
    ceiling."""
    W2, H2 = W / 2, H / 2
    return [
        (2, L, (0, -W2, W2), (1, -H2, H2)),
        (2, 0.0, (0, -W2, W2), (1, -H2, H2)),
        (0, -W2, (2, 0.0, L), (1, -H2, H2)),
        (0, W2, (2, 0.0, L), (1, -H2, H2)),
        (1, H2, (0, -W2, W2), (2, 0.0, L)),
        (1, -H2, (0, -W2, W2), (2, 0.0, L)),
    ]


def cast(planes, R_wc, origin, rays_cam):
    """Intersect rays with the box.

    R_wc [B,3,3] camera-to-world rotations, origin [B,3] camera centres,
    rays_cam [P,3] camera-frame directions. Returns (face [B,P] int64, -1
    where nothing is hit; t [B,P] ray parameter, inf where nothing is hit;
    a, b [B,P] the hit's coordinates on its face, from the face's low
    corner, in metres; d [B,P,3] the world-frame directions)."""
    # d = R_wc @ r, written out so no matrix product (TF32) is involved
    d = (rays_cam[None, :, None, :] * R_wc[:, None, :, :]).sum(-1)
    B, P = d.shape[:2]
    best = torch.full((B, P), math.inf, dtype=d.dtype, device=d.device)
    face = torch.full((B, P), -1, dtype=torch.int64, device=d.device)
    a = torch.zeros_like(best)
    b = torch.zeros_like(best)
    for f, (ax, val, (ua, ulo, uhi), (va, vlo, vhi)) in enumerate(planes):
        dz = d[..., ax]
        safe = torch.where(dz.abs() > 1e-9, dz, torch.ones_like(dz))
        t_hit = (val - origin[:, ax, None]) / safe
        pu = origin[:, ua, None] + t_hit * d[..., ua]
        pv = origin[:, va, None] + t_hit * d[..., va]
        ok = ((dz.abs() > 1e-9) & (t_hit > T_MIN) & (t_hit < best)
              & (pu >= ulo) & (pu <= uhi) & (pv >= vlo) & (pv <= vhi))
        best = torch.where(ok, t_hit, best)
        face = torch.where(ok, torch.full_like(face, f), face)
        a = torch.where(ok, pu - ulo, a)
        b = torch.where(ok, pv - vlo, b)
    return face, best, a, b, d


def texture_bank(n, size, generator, device):
    """n fractal-noise textures [n,size,size] float32 in 0-255."""
    coarse = torch.rand((n, 1, size // 8, size // 8), generator=generator, device=device) * 255
    fine = (torch.rand((n, 1, size // 2, size // 2), generator=generator, device=device)
            * 120 - 60)
    t = (F.interpolate(coarse, size=(size, size), mode="bicubic", align_corners=False)
         + F.interpolate(fine, size=(size, size), mode="bicubic", align_corners=False))
    return t.clamp(0, 255)[:, 0].contiguous()


class Hall:
    """The box hall of one seed: its size, and a texture of its own for every
    square tile of every face (with box-filtered levels)."""

    def __init__(self, width, height, length, seed, device, texture_px=256, tile_m=2.5,
                 levels=4):
        self.W, self.H, self.L = float(width), float(height), float(length)
        self.device = torch.device(device)
        self.tile_m = float(tile_m)
        self.texture_px = int(texture_px)
        self.levels = int(levels)
        self.planes = face_planes(self.W, self.H, self.L)
        # the tiles of each face, numbered face after face
        grid = [(math.ceil((uhi - ulo) / self.tile_m), math.ceil((vhi - vlo) / self.tile_m))
                for _, _, (_, ulo, uhi), (_, vlo, vhi) in self.planes]
        first = [0]
        for nu, nv in grid[:-1]:
            first.append(first[-1] + nu * nv)
        self.grid = torch.tensor(grid, device=self.device)
        self.first = torch.tensor(first, device=self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed) % (1 << 63))
        bank = texture_bank(first[-1] + grid[-1][0] * grid[-1][1], self.texture_px, gen,
                            self.device)
        mips = [bank]
        for _ in range(1, levels):
            mips.append(F.avg_pool2d(mips[-1][:, None], 2)[:, 0])
        self.sizes = [m.shape[-1] for m in mips]
        self.level_base = [0]
        for m in mips[:-1]:
            self.level_base.append(self.level_base[-1] + m.numel())
        self.texels = torch.cat([m.reshape(-1) for m in mips])

    def shade(self, face, t, a, b, d, focal):
        """Intensities [B,P] of the hits: bilinear in the hit tile's texture,
        at the level the texel footprint picks (0 where nothing is hit)."""
        hit = face >= 0
        f = face.clamp(min=0)
        nu, nv = self.grid[f, 0], self.grid[f, 1]
        iu = torch.minimum((a / self.tile_m).floor().clamp(min=0).to(torch.int64), nu - 1)
        iv = torch.minimum((b / self.tile_m).floor().clamp(min=0).to(torch.int64), nv - 1)
        fu = (a / self.tile_m - iu).clamp(0, 1)
        fv = (b / self.tile_m - iv).clamp(0, 1)
        tex = self.first[f] + iu * nv + iv
        x0 = fu * (self.texture_px - 1)
        y0 = fv * (self.texture_px - 1)
        # texels a pixel spans: hit distance over focal length, scaled by
        # the face's obliquity (|d|^2 / |d . n| for rays with z = 1)
        ax = torch.tensor([p[0] for p in self.planes], device=d.device)[f]
        dn = d.gather(-1, ax[..., None])[..., 0].abs().clamp(min=1e-6)
        dd = (d * d).sum(-1)
        foot = t.clamp(max=1e6) * dd / dn * (self.texture_px / self.tile_m) / focal
        lvl = torch.clamp(torch.log2(foot.clamp(min=1.0)).floor(), 0, self.levels - 1)
        lvl = lvl.to(torch.int64)
        scale = torch.pow(2.0, lvl.to(torch.float32))
        size = torch.tensor(self.sizes, device=d.device)[lvl]
        base = torch.tensor(self.level_base, device=d.device)[lvl]
        x = ((x0 + 0.5) / scale - 0.5).clamp(min=0)
        y = ((y0 + 0.5) / scale - 0.5).clamp(min=0)
        x = torch.minimum(x, (size - 1).to(x.dtype))
        y = torch.minimum(y, (size - 1).to(y.dtype))
        xi, yi = x.floor().to(torch.int64), y.floor().to(torch.int64)
        x1, y1 = torch.minimum(xi + 1, size - 1), torch.minimum(yi + 1, size - 1)
        wx, wy = x - xi, y - yi
        plane = base + tex * size * size

        def at(yy, xx):
            return self.texels[plane + yy * size + xx]

        val = (at(yi, xi) * (1 - wx) * (1 - wy) + at(yi, x1) * wx * (1 - wy)
               + at(y1, xi) * (1 - wx) * wy + at(y1, x1) * wx * wy)
        return torch.where(hit, val, torch.zeros_like(val))

    def render(self, R_wc, origin, rays_cam, focal):
        """Images [B,P] (float 0-255) and depths [B,P] (the ray parameter: z
        for rays with camera z = 1; 0 where nothing is hit) of the views
        (R_wc [B,3,3], origin [B,3])."""
        face, t, a, b, d = cast(self.planes, R_wc, origin, rays_cam)
        img = self.shade(face, t, a, b, d, float(focal))
        depth = torch.where(face >= 0, t, torch.zeros_like(t))
        return img, depth


def pinhole_rays(w, h, fx, fy, cx, cy, device, dist=None):
    """Camera-frame rays [h*w,3] with z = 1 through every pixel centre of a
    w x h image. With `dist` = (k1, k2, p1, p2, k3) the image is a distorted
    one: each pixel casts the ray that the radial-tangential model maps onto
    it (its undistorted normalized coordinates, inverted by fixed-point
    iteration in float64)."""
    vs, us = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=device),
                            torch.arange(w, dtype=torch.float64, device=device),
                            indexing="ij")
    xd = ((us - cx) / fx).reshape(-1)
    yd = ((vs - cy) / fy).reshape(-1)
    x, y = xd, yd
    if dist is not None and any(dist):
        k1, k2, p1, p2, k3 = dist
        for _ in range(40):
            r2 = x * x + y * y
            radial = 1 + r2 * (k1 + r2 * (k2 + r2 * k3))
            dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
            dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
            x = (xd - dx) / radial
            y = (yd - dy) / radial
    return torch.stack([x, y, torch.ones_like(x)], -1).to(torch.float32)

