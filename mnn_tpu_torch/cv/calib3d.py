"""calib3d: Rodrigues rotations and solvePnP.

Counterpart of the JAX package's `cv/calib3d.py` (the reference's
tools/cv calib3d: solvePnP and Rodrigues, used by face tracking).
`solve_pnp` takes a DLT initial pose by SVD, then 50 Gauss-Newton steps on
the reprojection error with the residuals' Jacobian from
`torch.func.jacrev` (the JAX package's `jax.jacobian`), in f32 on `device`
(None: the card).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch.func import jacrev

from mnn_tpu_torch.cv.common import host
from mnn_tpu_torch.kernels.common import resolve_device


def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Rotation vector [3] -> rotation matrix [3, 3] (f32)."""
    rvec = rvec.float()
    theta = torch.linalg.vector_norm(rvec)
    small = theta < 1e-8
    k = rvec / torch.where(small, torch.ones_like(theta), theta)
    kx, ky, kz = k[0], k[1], k[2]
    zero = torch.zeros_like(kx)
    big_k = torch.stack([torch.stack([zero, -kz, ky]), torch.stack([kz, zero, -kx]),
                         torch.stack([-ky, kx, zero])])
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    rot = eye + torch.sin(theta) * big_k + (1 - torch.cos(theta)) * (big_k @ big_k)
    return torch.where(small, eye, rot)


def rodrigues_inv(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [3, 3] -> rotation vector [3] (f32)."""
    rot = rot.float()
    cos = torch.clamp((torch.trace(rot) - 1) / 2, -1.0, 1.0)
    theta = torch.arccos(cos)
    axis = torch.stack([rot[2, 1] - rot[1, 2], rot[0, 2] - rot[2, 0], rot[1, 0] - rot[0, 1]])
    s = torch.linalg.vector_norm(axis)
    unit_x = torch.tensor([1.0, 0.0, 0.0], device=rot.device)
    axis = torch.where(s < 1e-8, unit_x, axis / torch.clamp(s, min=1e-8))
    return axis * theta


def _project(obj, rvec, tvec, cam):
    cam_pts = obj @ rodrigues(rvec).T + tvec
    uv = cam_pts[:, :2] / cam_pts[:, 2:3]
    return torch.stack([uv[:, 0] * cam[0, 0] + cam[0, 2], uv[:, 1] * cam[1, 1] + cam[1, 2]], 1)


def solve_pnp(object_points, image_points, camera_matrix, iterations: int = 50,
              device=None) -> Tuple[np.ndarray, np.ndarray]:
    """object_points [N, 3], image_points [N, 2], camera_matrix [3, 3] ->
    (rvec [3], tvec [3]) numpy, minimising the reprojection error."""
    dev = resolve_device(device)
    obj = torch.from_numpy(host(object_points).astype(np.float32)).to(dev)
    img = torch.from_numpy(host(image_points).astype(np.float32)).to(dev)
    cam = torch.from_numpy(host(camera_matrix).astype(np.float32)).to(dev)

    # DLT: the 2N x 12 system for P = K [R | t] on normalised coordinates
    n = obj.shape[0]
    ones = torch.ones((n, 1), device=dev)
    norm = (torch.cat([img, ones], 1) @ torch.linalg.inv(cam).T)[:, :2]
    u, v = norm[:, :1], norm[:, 1:]
    zeros = torch.zeros((n, 4), device=dev)
    xyz1 = torch.cat([obj, ones], 1)
    rows_u = torch.cat([xyz1, zeros, -u * xyz1], 1)
    rows_v = torch.cat([zeros, xyz1, -v * xyz1], 1)
    a = torch.stack([rows_u, rows_v], 1).reshape(2 * n, 12)
    p = torch.linalg.svd(a)[2][-1].reshape(3, 4)
    r_raw, t_raw = p[:, :3], p[:, 3]
    # orthonormalise, fix the scale and the sign (points in front)
    u_, s_, vt_ = torch.linalg.svd(r_raw)
    scale = s_.mean()
    r0 = u_ @ vt_
    sign = torch.sign(torch.linalg.det(r0))
    r0 = r0 * sign
    t0 = t_raw / scale * sign
    behind = (obj @ r0.T + t0)[:, 2].mean() < 0
    r0 = torch.where(behind, -r0, r0)
    t0 = torch.where(behind, -t0, t0)
    params = torch.cat([rodrigues_inv(r0), t0])

    def resid(q):
        return (_project(obj, q[:3], q[3:], cam) - img).reshape(-1)

    damp = 1e-6 * torch.eye(6, device=dev)
    for _ in range(iterations):
        jac = jacrev(resid)(params)
        r = resid(params)
        params = params - torch.linalg.solve(jac.T @ jac + damp, jac.T @ r)
    out = params.cpu().numpy()
    return out[:3], out[3:]
