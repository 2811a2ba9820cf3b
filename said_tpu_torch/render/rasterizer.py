"""Software mesh renderer for blendshape-animation previews, host numpy.

The port's copy of ``said_tpu.render.rasterizer`` (which is itself
numpy), so frames are bit-identical to the JAX package's. It replaces
the reference's pyrender/EGL offscreen path
(``script/rendering/render_visual.py``) with a z-buffer rasterizer:

- the same camera: intrinsics fx = fy = 4754.98 / 2, c = (400, 400),
  800×800, camera at z = 1 looking down −z;
- the same lights: four white point lights (intensity 2, at the camera
  position rotated ±30° about x and −30° about y) with inverse-square
  falloff, ambient 0.2, a 0.3 gray base colour, smooth vertex normals;
- optional per-vertex colours (viridis error heatmaps), as the
  reference's vertex-colour mode.

The per-frame geometry (deformation, normals, lighting) is vectorised;
triangles are filled one by one on the host (an offline preview tool).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from said_tpu_torch.utils.mesh import Mesh


def _rodrigues(rvec: np.ndarray) -> np.ndarray:
    """Axis-angle rotation vector → 3×3 rotation matrix."""
    theta = np.linalg.norm(rvec)
    if theta < 1e-12:
        return np.eye(3)
    k = rvec / theta
    kx = np.array(
        [[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]], dtype=np.float64
    )
    return np.eye(3) + np.sin(theta) * kx + (1 - np.cos(theta)) * (kx @ kx)


def _vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    v0, v1, v2 = (vertices[faces[:, i]] for i in range(3))
    fn = np.cross(v1 - v0, v2 - v0)
    normals = np.zeros_like(vertices)
    for i in range(3):
        np.add.at(normals, faces[:, i], fn)
    norm = np.linalg.norm(normals, axis=1, keepdims=True)
    return normals / np.maximum(norm, 1e-12)


class Renderer:
    """Fixed-camera offscreen renderer (reference ``RendererObject``)."""

    def __init__(self, z_offset: float = 0.0, width: int = 800, height: int = 800):
        self.width = width
        self.height = height
        self.fx = self.fy = 4754.97941935 / 2
        self.cx, self.cy = width / 2, height / 2
        self.near, self.far = 0.01, 3.0
        self.cam_pos = np.array([0.0, 0.0, 1.0 - z_offset])

        angle = np.pi / 6.0
        pos = self.cam_pos
        self.light_positions = np.stack(
            [
                pos,
                _rodrigues(np.array([angle, 0, 0])) @ pos,
                _rodrigues(np.array([-angle, 0, 0])) @ pos,
                _rodrigues(np.array([0, -angle, 0])) @ pos,
            ]
        )
        self.light_intensity = 2.0
        self.ambient = 0.2
        self.base_color = np.array([0.3, 0.3, 0.3])

    def render(
        self,
        mesh: Mesh,
        t_center: np.ndarray,
        rot: np.ndarray = None,
        vertex_colors: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Render one mesh → (H, W, 3) uint8 image."""
        vertices = np.asarray(mesh.vertices, dtype=np.float64)
        faces = np.asarray(mesh.faces)
        if rot is not None and np.linalg.norm(rot) > 0:
            vertices = (_rodrigues(rot) @ (vertices - t_center).T).T + t_center

        normals = _vertex_normals(vertices, faces)

        # Shade per vertex: Lambertian point lights with 1/d² falloff.
        if vertex_colors is not None:
            albedo = np.asarray(vertex_colors, dtype=np.float64)[:, :3]
        else:
            albedo = np.broadcast_to(self.base_color, (len(vertices), 3))

        shade = np.full(len(vertices), self.ambient)
        for lp in self.light_positions:
            to_light = lp[None, :] - vertices
            dist2 = np.sum(to_light**2, axis=1)
            ldir = to_light / np.sqrt(dist2)[:, None]
            ndotl = np.abs(np.sum(normals * ldir, axis=1))  # two-sided (SKIP_CULL)
            shade = shade + self.light_intensity * ndotl / np.maximum(dist2, 1e-9) / (4 * np.pi)
        colors = np.clip(albedo * shade[:, None], 0.0, 1.0)

        # Camera space (camera at cam_pos looking down −z) + projection.
        pc = vertices - self.cam_pos
        z = -pc[:, 2]
        valid_z = np.maximum(z, 1e-6)
        u = self.fx * pc[:, 0] / valid_z + self.cx
        v = self.cy - self.fy * pc[:, 1] / valid_z  # flip y to image coords

        img = np.zeros((self.height, self.width, 3), dtype=np.float64)
        zbuf = np.full((self.height, self.width), np.inf)

        tri_u = u[faces]  # (F, 3)
        tri_v = v[faces]
        tri_z = z[faces]
        tri_c = colors[faces]  # (F, 3, 3)

        # Skip triangles behind the camera or fully off-screen.
        ok = (tri_z > self.near).all(axis=1)
        ok &= (tri_u.max(axis=1) >= 0) & (tri_u.min(axis=1) < self.width)
        ok &= (tri_v.max(axis=1) >= 0) & (tri_v.min(axis=1) < self.height)

        order = np.argsort(-tri_z[ok].mean(axis=1))  # back-to-front hint (z-buffer decides)
        idxs = np.nonzero(ok)[0][order]

        for f in idxs:
            us, vs, zs, cs = tri_u[f], tri_v[f], tri_z[f], tri_c[f]
            x0 = max(int(np.floor(us.min())), 0)
            x1 = min(int(np.ceil(us.max())) + 1, self.width)
            y0 = max(int(np.floor(vs.min())), 0)
            y1 = min(int(np.ceil(vs.max())) + 1, self.height)
            if x0 >= x1 or y0 >= y1:
                continue
            xs = np.arange(x0, x1) + 0.5
            ys = np.arange(y0, y1) + 0.5
            gx, gy = np.meshgrid(xs, ys)

            d = (vs[1] - vs[2]) * (us[0] - us[2]) + (us[2] - us[1]) * (vs[0] - vs[2])
            if abs(d) < 1e-12:
                continue
            w0 = ((vs[1] - vs[2]) * (gx - us[2]) + (us[2] - us[1]) * (gy - vs[2])) / d
            w1 = ((vs[2] - vs[0]) * (gx - us[2]) + (us[0] - us[2]) * (gy - vs[2])) / d
            w2 = 1.0 - w0 - w1
            inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
            if not inside.any():
                continue

            # Perspective-correct interpolation in 1/z.
            inv_z = w0 / zs[0] + w1 / zs[1] + w2 / zs[2]
            pz = 1.0 / np.maximum(inv_z, 1e-12)
            patch_zbuf = zbuf[y0:y1, x0:x1]
            visible = inside & (pz < patch_zbuf) & (pz < self.far)
            if not visible.any():
                continue
            col = (
                (w0 / zs[0])[..., None] * cs[0]
                + (w1 / zs[1])[..., None] * cs[1]
                + (w2 / zs[2])[..., None] * cs[2]
            ) * pz[..., None]
            patch_img = img[y0:y1, x0:x1]
            patch_img[visible] = col[visible]
            patch_zbuf[visible] = pz[visible]

        return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def _viridis(x: np.ndarray) -> np.ndarray:
    """Minimal viridis colormap (matplotlib anchor points, lerped)."""
    anchors = np.array(
        [
            [0.267004, 0.004874, 0.329415],
            [0.282623, 0.140926, 0.457517],
            [0.253935, 0.265254, 0.529983],
            [0.206756, 0.371758, 0.553117],
            [0.163625, 0.471133, 0.558148],
            [0.127568, 0.566949, 0.550556],
            [0.134692, 0.658636, 0.517649],
            [0.266941, 0.748751, 0.440573],
            [0.477504, 0.821444, 0.318195],
            [0.741388, 0.873449, 0.149561],
            [0.993248, 0.906157, 0.143936],
        ]
    )
    x = np.clip(x, 0.0, 1.0) * (len(anchors) - 1)
    lo = np.floor(x).astype(int)
    hi = np.minimum(lo + 1, len(anchors) - 1)
    frac = (x - lo)[..., None]
    return anchors[lo] * (1 - frac) + anchors[hi] * frac


def render_blendshape_coefficients(
    renderer: Renderer,
    neutral_mesh: Mesh,
    blendshapes_matrix: np.ndarray,
    blendshape_coeffs: np.ndarray,
    target_blendshape_coeffs: Optional[np.ndarray] = None,
    max_diff: float = 0.001,
) -> List[np.ndarray]:
    """Render a coefficient sequence → list of (H, W, 3) uint8 frames.

    The per-frame vertex deformation ``coeffs @ B_Δᵀ + neutral`` is one
    matmul over the whole sequence. Optional per-vertex error heatmap
    against a target sequence (viridis, clipped at ``max_diff``), as in
    the reference.
    """
    neutral_vector = neutral_mesh.vertices.reshape(-1, 1)
    faces = neutral_mesh.faces
    delta = blendshapes_matrix - neutral_vector

    motion = blendshape_coeffs @ delta.T + neutral_vector.T  # (T, 3|V|)
    seq_len = motion.shape[0]
    num_vertices = motion.shape[1] // 3
    motion = motion.reshape(seq_len, num_vertices, 3)

    center = neutral_mesh.vertices.mean(axis=0)

    vertex_colors = None
    if target_blendshape_coeffs is not None:
        diff = ((target_blendshape_coeffs - blendshape_coeffs) @ delta.T).reshape(
            seq_len, num_vertices, 3
        )
        mag = np.sqrt((diff**2).sum(axis=2))
        vertex_colors = _viridis(np.clip(mag, 0, max_diff) / max_diff)

    frames = []
    for t in range(seq_len):
        mesh = Mesh(vertices=motion[t], faces=faces)
        frames.append(
            renderer.render(
                mesh,
                center,
                vertex_colors=None if vertex_colors is None else vertex_colors[t],
            )
        )
    return frames
