"""Visualization: pinhole camera, orbit controls, the single-bounce renderer
and the profile scanner.

Counterpart of ``raytracetorch_tpu/render/camera.py`` (``Camera``,
``OrbitCamera``, ``ior_color``, ``Renderer.render_3d`` and
``scan_profile``); the plots of ``render/viz.py`` are ROADMAP Queue 1 item
15.  The renderer is plain torch on the params' device, as the JAX
renderer is plain XLA: every row's nearest hit (apertures excluded from the
occlusion), ties to the first row (``torch.argmin``, as ``jnp.argmin``),
then each row's normal where it won, a color by its physics kind (the IOR
colormap white -> cyan -> blue -> navy -> purple for refracting rows) and
two-sided Lambert shading 0.3 + 0.7 |n.l|.
"""

from __future__ import annotations

import math

import torch

from ..constants import BIG, PhysKind
from ..core.intersect import intersect, normal_world
from ..rays.ray import Rays

_COLOR_REFLECT = (1.0, 0.6, 0.0)
_COLOR_BLOCK = (0.2, 0.2, 0.2)
_COLOR_TRANSMIT = (0.0, 0.8, 0.2)
_COLOR_OTHER = (1.0, 0.0, 1.0)

# IOR colormap breakpoints and their colors
_IOR_STOPS = (1.0, 1.3, 1.4, 1.7, 2.0)
_IOR_COLORS = (
    (0.9, 0.9, 0.9),   # white
    (0.0, 1.0, 1.0),   # cyan
    (0.3, 0.6, 1.0),   # blue
    (0.0, 0.0, 0.5),   # navy
    (0.3, 0.0, 0.3),   # purple
)


def _f32(v, device=None):
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _unit(v):
    return v / torch.linalg.norm(v)


class Camera:
    """Pinhole camera at ``position`` looking at ``look_at``."""

    def __init__(self, position, look_at, up_vector=(0.0, 1.0, 0.0),
                 fov_deg=45.0, width=640, height=480):
        self.width, self.height = int(width), int(height)
        self.fov_deg = float(fov_deg)
        self.origin = _f32(position)
        self._aim(_f32(look_at), _f32(up_vector))

    def _aim(self, target, up):
        self.forward = _unit(target - self.origin)
        self.right = _unit(torch.linalg.cross(self.forward, up))
        self.up_cam = torch.linalg.cross(self.right, self.forward)

    def generate_rays(self, device=None) -> Rays:
        """One ray per pixel, row-major, on ``device``."""
        aspect = self.width / self.height
        scale_y = torch.tan(torch.deg2rad(_f32(self.fov_deg * 0.5)))
        scale_x = scale_y * aspect
        y = _linspace(scale_y, -scale_y, self.height)
        x = _linspace(-scale_x, scale_x, self.width)
        yy, xx = torch.meshgrid(y, x, indexing='ij')
        dirs = (xx.reshape(-1, 1) * self.right
                + yy.reshape(-1, 1) * self.up_cam + self.forward)
        origins = self.origin.expand(dirs.shape)
        return Rays.create(origins.to(device), dirs.to(device))


def _linspace(start, stop, num):
    """float32 ``jnp.linspace``: start (1 - s) + stop s with s = i / (num -
    1), the last point exactly ``stop``."""
    if num == 1:
        return start.reshape(1)
    step = torch.arange(num - 1, dtype=torch.float32) / (num - 1)
    return torch.cat([start * (1 - step) + stop * step, stop.reshape(1)])


class OrbitCamera(Camera):
    """Turntable orbit, roll, pan and zoom about ``pivot``, with a fallback
    axis near the poles."""

    def __init__(self, pivot=(0.0, 0.0, 0.0), **kw):
        self.pivot = _f32(pivot)
        super().__init__(**kw)
        self.update_view_matrix()

    def update_view_matrix(self):
        direction = self.pivot - self.origin
        dist = torch.linalg.norm(direction)
        if float(dist) < 1e-3:
            return
        self.forward = direction / dist
        world_up = _f32([0.0, 1.0, 0.0])
        right = torch.linalg.cross(self.forward, world_up)
        if float(torch.linalg.norm(right)) < 1e-3:
            right = _f32([1.0, 0.0, 0.0])
        self.right = _unit(right)
        self.up_cam = _unit(torch.linalg.cross(self.right, self.forward))

    @staticmethod
    def _rotate(vec, axis, angle):
        c, s = math.cos(angle), math.sin(angle)
        return (vec * c + torch.linalg.cross(axis, vec) * s
                + axis * torch.dot(axis, vec) * (1 - c))

    def orbit(self, d_yaw, d_pitch):
        radius = self.origin - self.pivot
        world_up = _f32([0.0, 1.0, 0.0])
        radius = self._rotate(radius, world_up, -float(d_yaw))
        rhat = _unit(radius)
        if abs(float(torch.dot(rhat, world_up))) > 0.95:
            axis = _f32([1.0, 0.0, 0.0])
        else:
            axis = _unit(torch.linalg.cross(rhat, world_up))
        radius = self._rotate(radius, axis, float(d_pitch))
        self.origin = self.pivot + radius
        self.update_view_matrix()

    def roll(self, angle):
        c, s = math.cos(angle), math.sin(angle)
        right = c * self.right - s * self.up_cam
        self.up_cam = s * self.right + c * self.up_cam
        self.right = right

    def pan(self, dx, dy):
        move = self.right * -dx + self.up_cam * dy
        self.origin = self.origin + move
        self.pivot = self.pivot + move

    def zoom(self, delta):
        radius = self.origin - self.pivot
        scale = 1.0 - delta * 0.1
        if float(torch.linalg.norm(radius)) * scale < 0.1:
            scale = 1.0
        self.origin = self.pivot + radius * scale


def _interp(x, xp, fp):
    """``jnp.interp`` for ``x`` within [xp[0], xp[-1]]: the segment by
    ``searchsorted(..., right=True)``, clipped to the table."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, len(xp) - 1)
    dx = xp[i] - xp[i - 1]
    return fp[i - 1] + ((x - xp[i - 1]) / dx) * (fp[i] - fp[i - 1])


def ior_color(ior):
    """Piecewise-linear IOR colormap -> [..., 3]."""
    ior = torch.as_tensor(ior, dtype=torch.float32)
    stops = _f32(_IOR_STOPS, ior.device)
    colors = _f32(_IOR_COLORS, ior.device)
    ior = torch.clamp(ior, _IOR_STOPS[0], _IOR_STOPS[-1])
    x = ior.reshape(-1)
    return torch.stack([_interp(x, stops, colors[:, c]) for c in range(3)],
                       dim=-1).reshape(*ior.shape, 3)


class Renderer:
    """Single-bounce shaded renderer over the scene's surface table."""

    def __init__(self, scene, background_color=(1.0, 1.0, 1.0),
                 light_dir=(-0.5, 1.0, -1.0)):
        self.scene = scene
        self.bg = tuple(float(c) for c in background_color)
        self.light = _unit(_f32(light_dir)).tolist()
        # apertures do not occlude
        self._renderable = [not el.is_aperture for el in scene.elements]

    def _render_mask_list(self):
        mask = []
        for el, keep in zip(self.scene.elements, self._renderable):
            mask.extend([keep] * el.n_surfaces)
        return mask

    def render_3d(self, params, camera: Camera):
        """-> [H, W, 3] float32 image in [0, 1] on the params' device."""
        table = self.scene.build_table(params)
        rays = camera.generate_rays(table.tw.device)
        renderable = self._render_mask_list()
        static_meta = self.scene.static_meta()
        pos, direction = rays.pos_c, rays.dir_c
        lx, ly, lz = self.light

        ts = []
        for k in range(table.n_surfaces):
            if not renderable[k]:
                ts.append(torch.full_like(pos[0], BIG))
                continue
            res = intersect(table.row(k), pos, direction, static_meta[k])
            ts.append(torch.where(res['valid'], res['t'], BIG))
        t_all = torch.stack(ts)                      # [K, N]
        win = torch.argmin(t_all, dim=0)             # the first of equals
        hit = t_all.amin(dim=0) < BIG * 0.5

        r, g, b = (torch.full_like(pos[0], c) for c in self.bg)
        for k in range(table.n_surfaces):
            if not renderable[k]:
                continue
            row = table.row(k)
            meta = static_meta[k]
            res = intersect(row, pos, direction, meta)
            mask = hit & (win == k) & res['valid']
            n = normal_world(row, res['hit_s'], meta)
            if meta.ph == PhysKind.REFLECT:
                base = _COLOR_REFLECT
            elif meta.ph == PhysKind.BLOCK:
                base = _COLOR_BLOCK
            elif meta.ph in (PhysKind.TRANSMIT, PhysKind.LINEAR):
                base = _COLOR_TRANSMIT
            elif meta.ph in (PhysKind.SNELL, PhysKind.FRESNEL):
                base = ior_color(torch.maximum(row.ph[0], row.ph[1]))
            else:
                base = _COLOR_OTHER
            shading = 0.3 + 0.7 * torch.abs(n[0] * lx + n[1] * ly
                                            + n[2] * lz)
            r = torch.where(mask, base[0] * shading, r)
            g = torch.where(mask, base[1] * shading, g)
            b = torch.where(mask, base[2] * shading, b)

        img = torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 1.0)
        return img.reshape(camera.height, camera.width, 3)

    def scan_profile(self, params, element_index, axis='x', num_points=200,
                     bounds=(-11.0, 11.0), z_start=-100.0):
        """Cross-section of one element: a row of +z rays from ``z_start``
        across ``bounds`` along ``axis``, intersected with each of the
        element's rows (with that row's kinds) -> (coords [P], z [P, K],
        valid [P, K]) over the element's K rows."""
        table = self.scene.build_table(params)
        meta = self.scene.static_meta()
        el = self.scene.elements[element_index]
        start = sum(e.n_surfaces
                    for e in self.scene.elements[:element_index])
        dev = table.tw.device
        coords = torch.linspace(bounds[0], bounds[1], num_points,
                                dtype=torch.float32, device=dev)
        zeros = torch.zeros_like(coords)
        zs = torch.full_like(coords, z_start)
        origin = ((coords, zeros, zs) if axis == 'x'
                  else (zeros, coords, zs))
        direction = (zeros, zeros, torch.ones_like(coords))
        ts, valid = [], []
        for k in range(start, start + el.n_surfaces):
            res = intersect(table.row(k), origin, direction, meta[k])
            ts.append(res['t'])
            valid.append(res['valid'])
        return (coords, z_start + torch.stack(ts, dim=-1),
                torch.stack(valid, dim=-1))
