"""The traffic generator: textured ground, camera paths and rendered frames,
all from a traffic file's parameters, the configuration's camera and the
seed.

The scene is the repository's synthetic planar scene (a multi-scale block
noise texture on the plane z = 0, cameras at z = -height looking at +z,
tilted so that the plane is seen obliquely), moved from numpy on the host
to plain torch on the card and stretched into a strip long enough that a
camera exploring fresh ground never sees the same texture twice. Frames
are rendered with the configuration's lens distortion (radial k1, k2, k3
and tangential p1, p2) and 2x2 supersampling, and come out as uint8 on the
host, as a camera driver hands them in.

Every seed gives the same number of frames, the same speeds, amplitudes
and periods; the seed draws the texture and the phases of the motions.

A path is a list of segments, each a dict:
  {"kind": "explore", "frames": n}   fresh ground along +x at `speed_px`
      image pixels a frame (at the ground's distance), with a lateral weave
      and a yaw of the traffic's amplitudes;
  {"kind": "sweep", "frames": n}     back and forth over the stretch the
      path has covered so far: x by `sweep_x_m`, y by `sweep_y_m`, each the
      sum of two sinusoids of incommensurate periods, starting at rest at
      the pose where the previous segment ended.
A segment whose "frames" is "window" gets `fps * seconds` frames (plus
`spare_frames`), so that a window at the camera's own rate cannot run out;
FrameStream renders only the frames a run reaches.

A configuration's `sensor` says what each frame hands in besides the left
or colour view (camera_streams), all rendered by the camera's one Renderer
from its one ground:
  "monocular"  (the default) the view alone;
  "stereo"     the right view of a rectified pair: the left poses moved by
               the baseline bf / fx along the left camera's +x, through the
               same intrinsics (a stereo configuration has no distortion);
  "rgbd"       a depth image registered to the colour view: at each
               pixel the camera-frame z where its ray (the lens undone)
               meets the ground, as uint16 round(z * depth_map_factor), 0
               where the ray misses it (or lies past 16 bits), as TUM's
               depth PNGs are coded.
The left or colour view is the same frame a monocular configuration
renders at the same seed.
"""

from __future__ import annotations

import math

import numpy as np
import torch


SENSORS = ("monocular", "stereo", "rgbd")
DISTORTION = ("k1", "k2", "p1", "p2", "k3")


def sensor_of(cfg: dict) -> str:
    """The configuration's sensor, "monocular" where it names none, after
    checking that the configuration gives what that sensor needs."""
    sensor = cfg.get("sensor", "monocular")
    if sensor not in SENSORS:
        raise ValueError(f"sensor {sensor!r} is none of {SENSORS}")
    cam = cfg["camera"]
    if sensor != "monocular" and not float(cam.get("bf", 0.0)) > 0.0:
        raise ValueError(f"a {sensor} configuration needs camera.bf > 0")
    if sensor == "stereo" and any(float(cam.get(k, 0.0)) for k in DISTORTION):
        raise ValueError("ORB-SLAM2's stereo input is a rectified pair: a stereo "
                         "configuration has no distortion (k1, k2, p1, p2, k3 = 0)")
    if sensor == "rgbd" and not float(cfg.get("depth_map_factor", 0.0)) > 0.0:
        raise ValueError("an rgbd configuration needs depth_map_factor > 0")
    return sensor


def seed_generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63 - 1))
    return g


def make_texture(rows: int, cols: int, g: torch.Generator, device,
                 block: int = 8, mix_cell: int = 256) -> torch.Tensor:
    """f32[rows, cols] in [30, 225]: four block-noise layers (blocks of
    block/2 .. 4 block texels) mixed by weights that change every
    `mix_cell` texels, so each region has its own descriptor statistics."""
    def blocks(b):
        small = torch.rand((-(-rows // b), -(-cols // b)), generator=g,
                           device=device) * 255.0
        return small.repeat_interleave(b, 0).repeat_interleave(b, 1)[:rows, :cols]

    layers = torch.stack([blocks(max(block // 2, 4)), blocks(block),
                          blocks(2 * block), blocks(4 * block)])
    w = torch.rand((4, -(-rows // mix_cell), -(-cols // mix_cell)),
                   generator=g, device=device)
    w = w.repeat_interleave(mix_cell, 1).repeat_interleave(mix_cell, 2)
    w = w[:, :rows, :cols]
    w = w / w.sum(0, keepdim=True).clamp_min(1e-9)
    tex = (layers * w).sum(0)
    lo, hi = tex.min(), tex.max()
    return 30.0 + (tex - lo) / (hi - lo).clamp_min(1e-9) * 195.0


def _pose(C, yaw: float, tilt: float) -> np.ndarray:
    """Tcw of a camera at world centre C, tilted by `tilt` about its x axis
    and turned by `yaw` about the plane's normal."""
    ct, st = math.cos(tilt), math.sin(tilt)
    R_tilt = np.array([[1.0, 0.0, 0.0], [0.0, ct, -st], [0.0, st, ct]])
    cy, sy = math.cos(yaw), math.sin(yaw)
    Rwc = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]]) @ R_tilt
    T = np.eye(4)
    T[:3, :3] = Rwc.T
    T[:3, 3] = -Rwc.T @ np.asarray(C, np.float64)
    return T


def segment_frames(seg: dict, traffic: dict, camera: dict, seconds: int) -> int:
    n = seg["frames"]
    if n == "window":
        return int(math.ceil(camera["fps"] * seconds)) + int(traffic["spare_frames"])
    return int(n)


def camera_path(traffic: dict, camera: dict, seconds: int, seed: int):
    """(Tcw list f64[4,4], segment index of each frame) of one camera."""
    rng = np.random.default_rng([int(seed) % 2 ** 63, 0x5EED])
    h = float(traffic["height_m"])
    step = float(traffic["speed_px"]) * h / float(camera["fx"])
    tilt = float(traffic["tilt_rad"])
    poses, seg_of = [], []
    x = y = yaw = 0.0
    for si, seg in enumerate(traffic["path"]):
        n = segment_frames(seg, traffic, camera, seconds)
        if seg["kind"] == "explore":
            ph = rng.uniform(0, 2 * math.pi, 2)
            x0, y0, yaw0 = x, y, yaw
            py, pyaw = traffic["weave_period_frames"], traffic["yaw_period_frames"]
            for i in range(n):
                x = x0 + step * i
                y = y0 + traffic["weave_m"] * (math.sin(2 * math.pi * i / py + ph[0])
                                               - math.sin(ph[0]))
                yaw = yaw0 + traffic["yaw_rad"] * (
                    math.sin(2 * math.pi * i / pyaw + ph[1]) - math.sin(ph[1]))
                poses.append(_pose((x, y, -h), yaw, tilt))
                seg_of.append(si)
        elif seg["kind"] == "sweep":
            ph = rng.uniform(0, 2 * math.pi, 2)
            (ax, px1, px2), (ay, py1, py2) = (
                (traffic["sweep_x_m"], *traffic["sweep_x_periods"]),
                (traffic["sweep_y_m"], *traffic["sweep_y_periods"]))
            x0, y0, yaw0 = x, y, yaw

            def wave(i, a, p1, p2, f):
                # 0 at the segment's start, within about [-2a, a/2]: a slow
                # swing of period p1 and a quicker one of period p2.
                return -a * (0.75 * (1.0 - math.cos(2 * math.pi * i / p1))
                             + 0.25 * (math.cos(f) - math.cos(2 * math.pi * i / p2 + f)))

            for i in range(n):
                x = x0 + wave(i, ax, px1, px2, ph[0])
                y = y0 - wave(i, ay, py1, py2, ph[1])
                poses.append(_pose((x, y, -h), yaw0, tilt))
                seg_of.append(si)
        else:
            raise ValueError(f"unknown path segment kind {seg['kind']!r}")
    return poses, seg_of


def right_poses(poses, baseline: float) -> list:
    """The right camera of a rectified pair: each left Tcw moved by the
    baseline along the left camera's +x, Tcw_r = [I | (-b, 0, 0)] @ Tcw_l."""
    out = []
    for T in poses:
        R = np.array(T, np.float64)
        R[0, 3] -= baseline
        out.append(R)
    return out


class Renderer:
    """Renders one camera's frames of its own textured strip on `device`."""

    def __init__(self, camera: dict, traffic: dict, poses, g: torch.Generator,
                 device):
        self.cam = camera
        self.device = torch.device(device)
        h = float(traffic["height_m"])
        # Texels per metre: `texel_per_px` texels to an image pixel at the
        # ground's distance.
        self.tex_scale = float(traffic["texel_per_px"]) * float(camera["fx"]) / h
        C = np.array([-T[:3, :3].T @ T[:3, 3] for T in poses])
        reach = float(traffic["footprint_m"])
        self.x_min, self.y_min = C[:, 0].min() - reach, C[:, 1].min() - reach
        cols = int(math.ceil((C[:, 0].max() + reach - self.x_min) * self.tex_scale)) + 2
        rows = int(math.ceil((C[:, 1].max() + reach - self.y_min) * self.tex_scale)) + 2
        self.texture = make_texture(rows, cols, g, self.device)
        self.rays = self._rays(int(traffic.get("supersample", 2)))
        self.depth_rays = None

    def _rays(self, ss: int) -> torch.Tensor:
        """Unit-depth camera rays f64[3, H*ss, W*ss] of the subpixel samples
        of the distorted image: each sample's normalized distorted point
        inverted through the lens model (fixed-point iteration)."""
        c = self.cam
        W, H = int(c["width"]), int(c["height"])
        dev = self.device
        u = torch.arange(W * ss, device=dev, dtype=torch.float64) / ss - 0.5 + 0.5 / ss
        v = torch.arange(H * ss, device=dev, dtype=torch.float64) / ss - 0.5 + 0.5 / ss
        v, u = torch.meshgrid(v, u, indexing="ij")
        xd = (u - c["cx"]) / c["fx"]
        yd = (v - c["cy"]) / c["fy"]
        k1, k2, k3 = c.get("k1", 0.0), c.get("k2", 0.0), c.get("k3", 0.0)
        p1, p2 = c.get("p1", 0.0), c.get("p2", 0.0)
        x, y = xd, yd
        for _ in range(40):
            r2 = x * x + y * y
            radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
            dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
            dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
            x, y = (xd - dx) / radial, (yd - dy) / radial
        return torch.stack([x, y, torch.ones_like(x)])

    def render(self, Tcws) -> torch.Tensor:
        """u8[B, H, W] on the device, one frame per pose."""
        c = self.cam
        W, H = int(c["width"]), int(c["height"])
        ss = self.rays.shape[1] // H
        T = torch.as_tensor(np.stack(Tcws), dtype=torch.float64, device=self.device)
        Rwc = T[:, :3, :3].transpose(1, 2)
        C = -(Rwc @ T[:, :3, 3:])[..., 0]                         # [B, 3]
        d = torch.einsum("bij,jhw->bihw", Rwc, self.rays)         # [B, 3, h, w]
        s = -C[:, 2, None, None] / d[:, 2]
        X = (C[:, 0, None, None] + s * d[:, 0] - self.x_min) * self.tex_scale
        Y = (C[:, 1, None, None] + s * d[:, 1] - self.y_min) * self.tex_scale
        tex = self.texture
        rows, cols = tex.shape
        off = (s > 0) & ((X < 0) | (X > cols - 1) | (Y < 0) | (Y > rows - 1))
        if bool(off.any()):
            raise RuntimeError(
                f"{int(off.sum())} samples fall outside the {rows}x{cols} texture "
                "(its clamped border): footprint_m does not cover what this "
                "view sees")
        x0 = X.floor().clamp(0, cols - 2)
        y0 = Y.floor().clamp(0, rows - 2)
        fx = (X - x0).clamp(0, 1).float()
        fy = (Y - y0).clamp(0, 1).float()
        i = (y0.long() * cols + x0.long())
        flat = tex.reshape(-1)
        val = (flat[i] * (1 - fx) * (1 - fy) + flat[i + 1] * fx * (1 - fy)
               + flat[i + cols] * (1 - fx) * fy + flat[i + cols + 1] * fx * fy)
        val = torch.where(s > 0, val, torch.full_like(val, 127.0))
        img = val.reshape(-1, H, ss, W, ss).mean(dim=(2, 4))
        return img.round().clamp(0, 255).to(torch.uint8)

    def depth(self, Tcws, depth_map_factor: float) -> torch.Tensor:
        """i32[B, H, W] on the device, one depth image per pose, registered
        to the rendered view: at each pixel centre the camera-frame z where
        its ray meets the ground (the rays have unit z), coded as
        round(z * depth_map_factor); 0, no reading, where the ray misses the
        ground or the code would not fit in 16 bits, as a depth camera
        reports nothing past its range."""
        if self.depth_rays is None:
            self.depth_rays = self._rays(1)
        c = self.cam
        T = torch.as_tensor(np.stack(Tcws), dtype=torch.float64, device=self.device)
        Rwc = T[:, :3, :3].transpose(1, 2)
        C = -(Rwc @ T[:, :3, 3:])[..., 0]
        d_z = torch.einsum("bj,jhw->bhw", Rwc[:, 2], self.depth_rays)
        z = -C[:, 2, None, None] / d_z
        code = (z * depth_map_factor).round()
        code = torch.where((z > 0) & (code <= 65535), code, torch.zeros_like(z))
        return code.to(torch.int32).reshape(-1, int(c["height"]), int(c["width"]))


class FrameStream:
    """One camera's frames as host arrays, u8[H, W] views or, with a
    depth_map_factor, u16[H, W] depth images, rendered on the device a
    chunk at a time as the run reaches them: set-up renders only what it
    hands in, and the window only what it hands in, never the whole path.
    Chunks start at multiples of `chunk` frames, so a seed's frames are the
    same whenever they are rendered."""

    def __init__(self, renderer: Renderer, poses, chunk: int = 32, batch: int = 2,
                 depth_map_factor: float | None = None):
        c = renderer.cam
        self.renderer, self.poses = renderer, poses
        self.chunk, self.batch = int(chunk), int(batch)
        self.depth_map_factor = depth_map_factor
        self.frames = np.empty((len(poses), int(c["height"]), int(c["width"])),
                               np.uint8 if depth_map_factor is None else np.uint16)
        self.ready = 0

    def __len__(self) -> int:
        return len(self.poses)

    def render_to(self, n: int) -> None:
        """Frames [0, n) ready on the host (n rounded up to a whole chunk)."""
        n = min(-(-int(n) // self.chunk) * self.chunk, len(self.poses))
        for i in range(self.ready, n, self.batch):
            j = min(i + self.batch, n)
            if self.depth_map_factor is None:
                out = self.renderer.render(self.poses[i:j])
            else:
                out = self.renderer.depth(self.poses[i:j], self.depth_map_factor)
            self.frames[i:j] = out.cpu().numpy()
        self.ready = max(self.ready, n)

    def __getitem__(self, i: int) -> np.ndarray:
        if not 0 <= i < self.ready:
            raise IndexError(f"frame {i} not rendered (ready: {self.ready})")
        return self.frames[i]


def camera_streams(cfg: dict, traffic: dict, seconds: int, seed: int, device):
    """One camera's path and what its sensor hands in: (Tcw list, segment
    index of each frame, [FrameStream of the left or colour view, then the
    right view (stereo) or the depth image (rgbd)]), every stream rendered
    from the camera's one ground. The texture's extent follows the left
    path; a right view that leaves it fails its render."""
    sensor = sensor_of(cfg)
    cam = cfg["camera"]
    poses, seg_of = camera_path(traffic, cam, seconds, seed)
    r = Renderer(cam, traffic, poses, seed_generator(seed, device), device)
    streams = [FrameStream(r, poses)]
    if sensor == "stereo":
        b = float(cam["bf"]) / float(cam["fx"])
        if b >= float(traffic["footprint_m"]):
            raise ValueError(f"the baseline {b:.3f} m is not inside the ground's "
                             f"footprint_m {traffic['footprint_m']}")
        streams.append(FrameStream(r, right_poses(poses, b)))
    elif sensor == "rgbd":
        streams.append(FrameStream(r, poses,
                                   depth_map_factor=float(cfg["depth_map_factor"])))
    return poses, seg_of, streams
