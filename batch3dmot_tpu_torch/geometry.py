"""Vectorized 3D box, quaternion and projection geometry (numpy).

A copy of ``batch3dmot_tpu/geometry.py``: batched numpy in place of the
upstream pyquaternion, shapely and nuScenes-devkit geometry, used by the
synthetic scenes, the graph builder, track interpolation and the nuScenes
data plane (camera selection and crops, point-in-box masks, multisweep
transforms, detection matching).

Conventions (nuScenes):
  * quaternions are (w, x, y, z);
  * box size is (w, l, h) = (width, length, height); x points forward
    (length), y left (width), z up (height);
  * ``box_corners()`` returns the devkit corner ordering: first four = front
    face (clockwise from top-left), last four = rear face.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Quaternions
# ---------------------------------------------------------------------------


def quat_normalize(q: np.ndarray) -> np.ndarray:
    """Normalize quaternions, shape (..., 4)."""
    q = np.asarray(q, dtype=np.float64)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def quat_rotation_matrix(q: np.ndarray) -> np.ndarray:
    """Quaternion(s) (..., 4) wxyz -> rotation matrix (..., 3, 3)."""
    q = quat_normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.empty(q.shape[:-1] + (3, 3), dtype=np.float64)
    R[..., 0, 0] = 1 - 2 * (y * y + z * z)
    R[..., 0, 1] = 2 * (x * y - z * w)
    R[..., 0, 2] = 2 * (x * z + y * w)
    R[..., 1, 0] = 2 * (x * y + z * w)
    R[..., 1, 1] = 1 - 2 * (x * x + z * z)
    R[..., 1, 2] = 2 * (y * z - x * w)
    R[..., 2, 0] = 2 * (x * z - y * w)
    R[..., 2, 1] = 2 * (y * z + x * w)
    R[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def quat_multiply(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    """Hamilton product of quaternions (..., 4) wxyz."""
    q1 = np.asarray(q1, dtype=np.float64)
    q2 = np.asarray(q2, dtype=np.float64)
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return np.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


def quat_inverse(q: np.ndarray) -> np.ndarray:
    """Inverse of unit quaternion(s): the conjugate."""
    q = quat_normalize(q)
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate vectors v (..., 3) by quaternions q (..., 4)."""
    R = quat_rotation_matrix(q)
    return np.einsum("...ij,...j->...i", R, v)


def quaternion_yaw(q: np.ndarray) -> np.ndarray:
    """Yaw of box orientation quaternion(s) (..., 4) -> (...,).

    Projects the rotated x-axis into the xy plane; matches the reference's
    ``geo_utils.quaternion_yaw`` (geo_utils.py:59-73).
    """
    q = quat_normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    # R @ [1,0,0] = (1-2(y^2+z^2), 2(xy+zw), 2(xz-yw))
    return np.arctan2(2 * (x * y + z * w), 1 - 2 * (y * y + z * z))


def yaw_to_quat(yaw: np.ndarray) -> np.ndarray:
    """Yaw angle(s) -> quaternion(s) rotating about +z."""
    yaw = np.asarray(yaw, dtype=np.float64)
    half = yaw / 2.0
    zeros = np.zeros_like(half)
    return np.stack([np.cos(half), zeros, zeros, np.sin(half)], axis=-1)


# ---------------------------------------------------------------------------
# Scalar/batched box metrics (reference geo_utils.py)
# ---------------------------------------------------------------------------


def angle_diff(x: np.ndarray, y: np.ndarray, period: float = 2 * np.pi) -> np.ndarray:
    """Signed smallest angle difference x - y in (-pi, pi].

    Matches reference ``geo_utils.angle_diff`` (geo_utils.py:7-21) including
    its fold of (pi, 2pi] -> (-pi, 0].
    """
    diff = (np.asarray(x) - np.asarray(y) + period / 2) % period - period / 2
    return np.where(diff > np.pi, diff - 2 * np.pi, diff)


def center_distance_xy(c1: np.ndarray, c2: np.ndarray) -> np.ndarray:
    """L2 distance between box centers using xy only (geo_utils.py:24-31).

    c1, c2: (..., 3) or (..., 2) centers.
    """
    d = np.asarray(c1)[..., :2] - np.asarray(c2)[..., :2]
    return np.linalg.norm(d, axis=-1)


def velocity_l2(v1: np.ndarray, v2: np.ndarray) -> np.ndarray:
    """L2 distance between velocity vectors (geo_utils.py:34-42)."""
    return np.linalg.norm(np.asarray(v1) - np.asarray(v2), axis=-1)


def scale_iou(wlh1: np.ndarray, wlh2: np.ndarray) -> np.ndarray:
    """Aligned-box 3D IoU from sizes only (geo_utils.py:76-99)."""
    wlh1 = np.asarray(wlh1, dtype=np.float64)
    wlh2 = np.asarray(wlh2, dtype=np.float64)
    inter = np.prod(np.minimum(wlh1, wlh2), axis=-1)
    union = np.prod(wlh1, axis=-1) + np.prod(wlh2, axis=-1) - inter
    return inter / union


def box_volume(wlh: np.ndarray) -> np.ndarray:
    """Volume of boxes from (w, l, h) sizes (geo_utils.py:102-115)."""
    return np.prod(np.asarray(wlh, dtype=np.float64), axis=-1)


# ---------------------------------------------------------------------------
# Box corners and point-in-box tests
# ---------------------------------------------------------------------------

# Devkit corner ordering (Box.corners): x forward (length), y left (width),
# z up (height).
_X_SIGNS = np.array([1, 1, 1, 1, -1, -1, -1, -1], dtype=np.float64)
_Y_SIGNS = np.array([1, -1, -1, 1, 1, -1, -1, 1], dtype=np.float64)
_Z_SIGNS = np.array([1, 1, -1, -1, 1, 1, -1, -1], dtype=np.float64)


def box_corners(
    center: np.ndarray,
    wlh: np.ndarray,
    quat: np.ndarray,
    wlh_factor: float = 1.0,
) -> np.ndarray:
    """Corners of boxes -> (..., 3, 8) in devkit ordering.

    center (..., 3); wlh (..., 3) as (width, length, height); quat (..., 4).
    """
    center = np.asarray(center, dtype=np.float64)
    wlh = np.asarray(wlh, dtype=np.float64) * wlh_factor
    w, l, h = wlh[..., 0], wlh[..., 1], wlh[..., 2]
    x = (l / 2)[..., None] * _X_SIGNS
    y = (w / 2)[..., None] * _Y_SIGNS
    z = (h / 2)[..., None] * _Z_SIGNS
    local = np.stack([x, y, z], axis=-2)  # (..., 3, 8)
    R = quat_rotation_matrix(quat)
    world = np.einsum("...ij,...jk->...ik", R, local)
    return world + center[..., :, None]


def bottom_corners(center, wlh, quat) -> np.ndarray:
    """Bottom face corners (..., 3, 4): devkit Box.bottom_corners order [2,3,7,6]."""
    return box_corners(center, wlh, quat)[..., :, [2, 3, 7, 6]]


def points_in_box(
    center: np.ndarray,
    wlh: np.ndarray,
    quat: np.ndarray,
    points: np.ndarray,
    wlh_factor: float = 1.0,
    ignore_z: bool = False,
) -> np.ndarray:
    """Point-in-oriented-box test for one box.

    points: (3, n). Returns boolean (n,). With ``ignore_z=True`` reproduces the
    radar variant that drops the vertical check (reference radar.py:120-151);
    otherwise the devkit 3-axis projection test.
    """
    corners = box_corners(center, wlh, quat, wlh_factor=wlh_factor)
    p1 = corners[:, 0]
    p_x = corners[:, 4]
    p_y = corners[:, 1]
    p_z = corners[:, 3]
    i = p_x - p1
    j = p_y - p1
    k = p_z - p1
    v = np.asarray(points, dtype=np.float64) - p1.reshape(3, 1)
    iv = i @ v
    jv = j @ v
    mask = (0 <= iv) & (iv <= i @ i) & (0 <= jv) & (jv <= j @ j)
    if not ignore_z:
        kv = k @ v
        mask &= (0 <= kv) & (kv <= k @ k)
    return mask


# ---------------------------------------------------------------------------
# Camera projection (reference utils/nuscenes.py:187-273)
# ---------------------------------------------------------------------------


def view_points(points: np.ndarray, view: np.ndarray, normalize: bool) -> np.ndarray:
    """Project 3D points (3, n) through a <=4x4 view matrix; devkit-compatible."""
    points = np.asarray(points, dtype=np.float64)
    view = np.asarray(view, dtype=np.float64)
    viewpad = np.eye(4)
    viewpad[: view.shape[0], : view.shape[1]] = view
    n = points.shape[1]
    hom = np.concatenate([points, np.ones((1, n))])
    out = (viewpad @ hom)[:3]
    if normalize:
        out = out / out[2:3]
    return out


def count_box_corners_in_image(
    corners_3d: np.ndarray, intrinsic: np.ndarray, imsize: tuple
) -> tuple:
    """(num_visible_corners, num_in_front) for one box's (3, 8) camera-frame
    corners; matches reference ``count_box_corners_in_image``
    (utils/nuscenes.py:187-207) including its z > 1 visibility depth gate."""
    corners_img = view_points(corners_3d, intrinsic, normalize=True)[:2]
    visible = (
        (corners_img[0] > 0)
        & (corners_img[0] < imsize[0])
        & (corners_img[1] > 0)
        & (corners_img[1] < imsize[1])
        & (corners_3d[2] > 1)
    )
    in_front = corners_3d[2] > 0.1
    return int(visible.sum()), int(in_front.sum())


# ---------------------------------------------------------------------------
# Polygon machinery (replaces shapely)
# ---------------------------------------------------------------------------


def _cross2(a: np.ndarray, b: np.ndarray) -> float:
    return float(a[0] * b[1] - a[1] * b[0])


def convex_hull(points: np.ndarray) -> np.ndarray:
    """Convex hull of 2D points (n, 2) -> hull vertices in CCW order (m, 2).

    Andrew's monotone chain. Degenerate inputs (collinear, <3 points) return
    the reduced chain (the intersection-with-canvas below handles them).
    """
    pts = np.unique(np.asarray(points, dtype=np.float64), axis=0)
    if len(pts) <= 2:
        return pts
    # sort by (x, y)
    order = np.lexsort((pts[:, 1], pts[:, 0]))
    pts = pts[order]

    def half(points_iter):
        chain: list = []
        for p in points_iter:
            while (
                len(chain) >= 2
                and _cross2(chain[-1] - chain[-2], p - chain[-2]) <= 0
            ):
                chain.pop()
            chain.append(p)
        return chain

    lower = half(pts)
    upper = half(pts[::-1])
    return np.array(lower[:-1] + upper[:-1])


def polygon_area(poly: np.ndarray) -> float:
    """Shoelace area of a polygon (n, 2); 0 for degenerate inputs."""
    if len(poly) < 3:
        return 0.0
    x, y = poly[:, 0], poly[:, 1]
    return float(abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))) / 2)


def clip_polygon_to_box(
    poly: np.ndarray, xmin: float, ymin: float, xmax: float, ymax: float
) -> np.ndarray:
    """Sutherland–Hodgman clip of polygon (n, 2) against an axis-aligned box."""
    poly = np.asarray(poly, dtype=np.float64)

    def clip_edge(pts, inside, intersect):
        if len(pts) == 0:
            return pts
        out = []
        for idx in range(len(pts)):
            cur, nxt = pts[idx], pts[(idx + 1) % len(pts)]
            cur_in, nxt_in = inside(cur), inside(nxt)
            if cur_in:
                out.append(cur)
                if not nxt_in:
                    out.append(intersect(cur, nxt))
            elif nxt_in:
                out.append(intersect(cur, nxt))
        return np.array(out) if out else np.empty((0, 2))

    def x_intersect(x0):
        def f(a, b):
            t = (x0 - a[0]) / (b[0] - a[0])
            return np.array([x0, a[1] + t * (b[1] - a[1])])

        return f

    def y_intersect(y0):
        def f(a, b):
            t = (y0 - a[1]) / (b[1] - a[1])
            return np.array([a[0] + t * (b[0] - a[0]), y0])

        return f

    poly = clip_edge(poly, lambda p: p[0] >= xmin, x_intersect(xmin))
    poly = clip_edge(poly, lambda p: p[0] <= xmax, x_intersect(xmax))
    poly = clip_edge(poly, lambda p: p[1] >= ymin, y_intersect(ymin))
    poly = clip_edge(poly, lambda p: p[1] <= ymax, y_intersect(ymax))
    return poly


def convex_polygon_intersection_area(p1: np.ndarray, p2: np.ndarray) -> float:
    """Intersection area of two convex polygons via Sutherland–Hodgman against
    each edge of p2 (works because both are convex)."""
    p1 = np.asarray(p1, dtype=np.float64)
    p2 = np.asarray(p2, dtype=np.float64)
    if len(p1) < 3 or len(p2) < 3:
        return 0.0
    # ensure p2 is CCW
    if _signed_area(p2) < 0:
        p2 = p2[::-1]
    poly = p1
    n = len(p2)
    for idx in range(n):
        a, b = p2[idx], p2[(idx + 1) % n]
        edge = b - a
        if len(poly) == 0:
            return 0.0
        keep = []
        m = len(poly)
        for j in range(m):
            cur, nxt = poly[j], poly[(j + 1) % m]
            cur_in = _cross2(edge, cur - a) >= 0
            nxt_in = _cross2(edge, nxt - a) >= 0
            if cur_in:
                keep.append(cur)
                if not nxt_in:
                    keep.append(_seg_line_intersect(cur, nxt, a, b))
            elif nxt_in:
                keep.append(_seg_line_intersect(cur, nxt, a, b))
        poly = np.array(keep) if keep else np.empty((0, 2))
    return polygon_area(poly)


def _signed_area(poly: np.ndarray) -> float:
    x, y = poly[:, 0], poly[:, 1]
    return float((np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))) / 2)


def _seg_line_intersect(p, q, a, b):
    d1 = q - p
    d2 = b - a
    denom = d1[0] * d2[1] - d1[1] * d2[0]
    t = ((a[0] - p[0]) * d2[1] - (a[1] - p[1]) * d2[0]) / denom
    return p + t * d1


def post_process_coords(
    corner_coords: np.ndarray, imsize: tuple = (1600, 900)
):
    """Intersect the convex hull of reprojected box corners with the image
    canvas; returns (min_x, min_y, max_x, max_y) or None (reference
    utils/nuscenes.py:247-273, shapely-free)."""
    pts = np.asarray(corner_coords, dtype=np.float64)
    if len(pts) == 0:
        return None
    hull = convex_hull(pts)
    clipped = clip_polygon_to_box(hull, 0, 0, imsize[0], imsize[1])
    if len(clipped) == 0:
        return None
    # shapely returns None when the hull only touches the canvas boundary in
    # a degenerate way; a zero-area clipped polygon with <3 vertices matches.
    if len(clipped) < 3 and len(hull) >= 3:
        return None
    return (
        float(clipped[:, 0].min()),
        float(clipped[:, 1].min()),
        float(clipped[:, 0].max()),
        float(clipped[:, 1].max()),
    )


def iou2d_bev(
    center1, wlh1, quat1, center2, wlh2, quat2
) -> float:
    """BEV IoU of two boxes from their bottom corners.

    NOTE: matches the reference's ``iou2d`` formula *exactly*
    (geo_utils.py:145-164), which computes inter / (area1 - inter + area2) —
    a quirk that differs from the standard union by double-counting nothing
    only when inter==0; replicated for parity.
    """
    c1 = bottom_corners(center1, wlh1, quat1)[:2].T  # (4, 2)
    c2 = bottom_corners(center2, wlh2, quat2)[:2].T
    a1 = polygon_area(c1)
    a2 = polygon_area(c2)
    inter = convex_polygon_intersection_area(c1, c2)
    if inter <= 0.0:
        return 0.0
    return inter / ((a1 - inter) + a2)


# ---------------------------------------------------------------------------
# Rigid transforms (devkit transform_matrix equivalent)
# ---------------------------------------------------------------------------


def transform_matrix(
    translation: np.ndarray, quat: np.ndarray, inverse: bool = False
) -> np.ndarray:
    """4x4 homogeneous transform from translation + quaternion (devkit-style)."""
    tm = np.eye(4)
    R = quat_rotation_matrix(quat)
    t = np.asarray(translation, dtype=np.float64)
    if inverse:
        tm[:3, :3] = R.T
        tm[:3, 3] = R.T @ (-t)
    else:
        tm[:3, :3] = R
        tm[:3, 3] = t
    return tm


def boxes_global_to_ego(
    centers: np.ndarray,
    quats: np.ndarray,
    velocities: np.ndarray,
    ego_translation: np.ndarray,
    ego_rotation: np.ndarray,
):
    """Transform boxes from global to ego-vehicle frame (batched).

    Mirrors devkit Box.translate(-t); Box.rotate(q_ego^-1): center' =
    R^-1 (c - t); orientation' = q_ego^-1 * q; velocity' = R^-1 v.
    """
    q_inv = quat_inverse(ego_rotation)
    R_inv = quat_rotation_matrix(q_inv)
    centers = (np.asarray(centers) - np.asarray(ego_translation)) @ R_inv.T
    quats = quat_multiply(q_inv, quats)
    velocities = np.asarray(velocities) @ R_inv.T
    return centers, quats, velocities


def boxes_ego_to_global(
    centers: np.ndarray,
    quats: np.ndarray,
    velocities: np.ndarray,
    ego_translation: np.ndarray,
    ego_rotation: np.ndarray,
):
    """Inverse of :func:`boxes_global_to_ego` (reference
    construct...parallel.py:397-398 rotate-then-translate order)."""
    R = quat_rotation_matrix(ego_rotation)
    centers = np.asarray(centers) @ R.T + np.asarray(ego_translation)
    quats = quat_multiply(ego_rotation, quats)
    velocities = np.asarray(velocities) @ R.T
    return centers, quats, velocities
