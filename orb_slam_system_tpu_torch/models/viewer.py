"""Headless viewer: frame annotation, status text, map export and the live
page (the JAX package's orb_slam_system_tpu/models/viewer.py, which stands
in for the reference's Viewer, FrameDrawer and MapDrawer):

  * annotate_frame: the FrameDrawer overlay burned into the grayscale image
    (boxes on tracked map and VO points, match lines while initializing);
  * status_text: the FrameDrawer status line;
  * export_map_ply: map points, keyframe centres and the covisibility and
    spanning-tree edges as a PLY file;
  * LiveViewer: the Viewer window as a page on localhost (frame, 3D map,
    the menu's toggles, AR cubes); StatsViewer: a status line per frame;
  * write_pgm, encode_png: image writers on the standard library.

The viewer reads host copies only: a frame's features where it has them,
else one copy of its keypoints' pixels per drawn frame, so it adds no
device fetch to tracking. Departs from the JAX viewer in one place: a line
segment is clipped to the image before it is sampled (_line), so a cube
vertex far off screen costs samples bounded by the image's size; the JAX
_line samples the whole segment and clamps each sample to the border.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional

import numpy as np

GREEN = (80, 235, 80)    # tracked MAP points (reference FrameDrawer :55-58)
BLUE = (90, 140, 255)    # tracked VO points, localization mode (:59-62)
INIT = (80, 235, 80)     # init match lines (:41-46, green in upstream)
CUBE = (230, 70, 230)    # AR cubes in the live frame


def _box(out: np.ndarray, x: int, y: int, box: int, color):
    H, W = out.shape[:2]
    x0, x1 = max(x - box, 0), min(x + box, W - 1)
    y0, y1 = max(y - box, 0), min(y + box, H - 1)
    out[y0, x0:x1 + 1] = color
    out[y1, x0:x1 + 1] = color
    out[y0:y1 + 1, x0] = color
    out[y0:y1 + 1, x1] = color


def clip_segment(p0, p1, W: int, H: int):
    """The part of the segment p0-p1 inside [0, W-1] x [0, H-1]
    (Liang-Barsky): (p0, p1) themselves where the whole segment is inside,
    else two new points, or None where none of it is (or an end is not
    finite)."""
    x0, y0 = float(p0[0]), float(p0[1])
    dx, dy = float(p1[0]) - x0, float(p1[1]) - y0
    if not np.isfinite([x0, y0, dx, dy]).all():
        return None
    t0, t1 = 0.0, 1.0
    for p, q in ((-dx, x0), (dx, W - 1 - x0), (-dy, y0), (dy, H - 1 - y0)):
        if p == 0.0:
            if q < 0.0:
                return None
            continue
        r = q / p
        if p < 0.0:
            t0 = max(t0, r)
        else:
            t1 = min(t1, r)
        if t0 > t1:
            return None
    if t0 == 0.0 and t1 == 1.0:
        return p0, p1
    return (x0 + t0 * dx, y0 + t0 * dy), (x0 + t1 * dx, y0 + t1 * dy)


def _line(out: np.ndarray, p0, p1, color):
    """Sampled line segment (no cv2), clipped to the image first: at most
    max(W, H) + 1 samples. A segment inside the image draws the JAX
    _line's pixels."""
    H, W = out.shape[:2]
    seg = clip_segment(p0, p1, W, H)
    if seg is None:
        return
    p0, p1 = seg
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1))
    t = np.linspace(0.0, 1.0, n + 1)
    xs = np.clip(np.round(p0[0] + (p1[0] - p0[0]) * t), 0, W - 1).astype(int)
    ys = np.clip(np.round(p0[1] + (p1[1] - p0[1]) * t), 0, H - 1).astype(int)
    out[ys, xs] = color


def annotate_frame(img: np.ndarray, xy: np.ndarray, tracked_mask: np.ndarray,
                   box: int = 3, vo_mask: Optional[np.ndarray] = None,
                   init_vis=None) -> np.ndarray:
    """The reference FrameDrawer::DrawFrame overlay (src/FrameDrawer.cc:
    16-90): while NOT_INITIALIZED, green lines between the init reference
    keypoints and their current matches (:27-48); while tracking, GREEN
    boxes on tracked map points and BLUE boxes on tracked VO points
    (localization mode's temporary depth points, :49-66).
    img f32[H,W] -> u8[H,W,3]."""
    g = np.clip(img, 0, 255).astype(np.uint8)
    out = np.repeat(g[..., None], 3, axis=2).copy()
    if init_vis is not None:
        ref_xy, cur_xy = init_vis
        for p0, p1 in zip(np.asarray(ref_xy), np.asarray(cur_xy)):
            _line(out, p0, p1, INIT)
        return out
    vo = (np.zeros(len(tracked_mask), bool) if vo_mask is None
          else np.asarray(vo_mask, bool))
    for k in np.nonzero(tracked_mask)[0]:
        _box(out, int(xy[k, 0]), int(xy[k, 1]), box,
             BLUE if vo[k] else GREEN)
    return out


def status_text(state, n_kfs: int, n_mps: int, n_tracked: int,
                n_vo: int = 0, localization: bool = False) -> str:
    """Reference FrameDrawer status line (:49-66): mode, map sizes, match
    count; localization mode reports map matches and VO matches apart."""
    mode = "LOCALIZATION MODE" if localization else "SLAM MODE"
    line = (f"{mode} | state: {state.name} | KFs: {n_kfs} | "
            f"MPs: {n_mps} | Matches: {n_tracked}")
    if localization or n_vo:
        line += f" | VO matches: {n_vo}"
    return line


def export_map_ply(path: str, arena, draw_graph: bool = True):
    """Map points (grey), keyframe centres (red) and covisibility and
    spanning-tree edges as a PLY file (reference MapDrawer::DrawMapPoints /
    DrawKeyFrames, src/MapDrawer.cc:21-198)."""
    with arena.lock:   # a consistent snapshot against the mapping worker
        return _export_map_ply_locked(path, arena, draw_graph)


def _export_map_ply_locked(path: str, arena, draw_graph: bool = True):
    pts = []
    cols = []
    for mp in arena.mps.values():
        pts.append(mp.pos)
        cols.append((200, 200, 200))
    kf_ids = sorted(arena.kfs)
    kf_pos = {}
    for k in kf_ids:
        kf_pos[k] = len(pts)
        pts.append(arena.kfs[k].camera_center())
        cols.append((255, 50, 50))
    edges = []
    if draw_graph:
        for k in kf_ids:
            kf = arena.kfs[k]
            for nb in kf.covis:
                if nb > k and nb in kf_pos:
                    edges.append((kf_pos[k], kf_pos[nb]))
            if kf.parent >= 0 and kf.parent in kf_pos:
                edges.append((kf_pos[k], kf_pos[kf.parent]))
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\n"
                "property uchar blue\n")
        f.write(f"element edge {len(edges)}\n")
        f.write("property int vertex1\nproperty int vertex2\n")
        f.write("end_header\n")
        for p, c in zip(pts, cols):
            f.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f} {c[0]} {c[1]} {c[2]}\n")
        for a, b in edges:
            f.write(f"{a} {b}\n")


def _point_classes(cur):
    """(tracked, vo) masks of the current frame: tracked = bound,
    non-outlier features; vo = those on temporary VO depth points
    (localization mode; the reference FrameDrawer :59-62 draws them as the
    second class)."""
    if cur is None:
        z = np.zeros(0, bool)
        return z, z
    tracked = (cur.mp_ids >= 0) & ~cur.outlier
    vo = np.zeros_like(tracked)
    for slot in (cur.vo_points or {}):
        if 0 <= slot < len(vo):
            vo[slot] = True
    vo &= tracked
    return tracked, vo


def frame_xy(cur) -> np.ndarray:
    """Keypoint pixels of a frame: its host features where it has them,
    else one copy of the packed buffer's two pixel columns (which leaves
    the frame's features unfetched)."""
    if cur.feats_host is not None:
        return cur.feats_host.xy
    return cur.packed[:, 0:2].cpu().numpy()


def write_pgm(path: str, img: np.ndarray):
    """Write a u8 grayscale image as binary PGM (no external codecs)."""
    img = np.clip(img, 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(f"P5\n{img.shape[1]} {img.shape[0]}\n255\n".encode())
        f.write(img.tobytes())


def encode_png(img: np.ndarray) -> bytes:
    """Encode a u8 grayscale [H,W] or RGB [H,W,3] image as PNG with
    stdlib zlib only. A uint16 [H,W] array is written as a 16-bit
    grayscale PNG with its values kept (a TUM depth map); the JAX encoder
    clips every input to u8."""
    H, W = img.shape[:2]
    if img.dtype == np.uint16 and img.ndim == 2:
        bit_depth, color_type = 16, 0
        rows = img.astype(">u2")
    else:
        img = np.clip(img, 0, 255).astype(np.uint8)
        bit_depth, color_type = 8, (2 if img.ndim == 3 else 0)
        rows = img
    raw = b"".join(b"\x00" + rows[i].tobytes() for i in range(H))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", W, H, bit_depth, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


_LIVE_HTML = """<!doctype html><html><head><title>orb-slam</title>
<style>body{background:#111;color:#ddd;font-family:monospace;margin:12px}
canvas,img{border:1px solid #444;background:#000}
button{margin:2px;padding:4px 10px;background:#333;color:#ddd;border:1px solid #555;cursor:pointer}
button.on{background:#265f26}
#row{display:flex;gap:12px;flex-wrap:wrap}</style></head><body>
<div id="status">connecting...</div>
<div id="row">
 <div><img id="frame" width="640"/></div>
 <div><canvas id="map" width="560" height="560"></canvas><br/>
  <span style="color:#888">drag: rotate &middot; wheel: zoom &middot;
  green frustum: camera &middot; blue: covisibility &middot;
  gray: spanning tree &middot; red: loop edges</span></div>
</div>
<div>
 <button id="follow" class="on" onclick="toggleFollow()">follow camera</button>
 <button id="loc" onclick="cmd('toggle_localization')">localization mode</button>
 <button onclick="cmd('reset')">reset</button>
 <button onclick="cmd('insert_cube')">insert cube</button>
 <button onclick="cmd('clear_cubes')">clear cubes</button>
 <a href="/map.ply" download><button>download map.ply</button></a>
</div>
<script>
let follow = true;
let yaw = 0.6, pitch = -0.5, dist = 6.0, target = [0,0,0];
function toggleFollow(){follow=!follow;
  document.getElementById('follow').classList.toggle('on',follow);}
function cmd(a){fetch('/cmd?action='+a,{method:'POST'});}
const cv0 = document.getElementById('map');
let drag = null;
cv0.addEventListener('mousedown', e=>{drag=[e.clientX,e.clientY];});
window.addEventListener('mouseup', ()=>{drag=null;});
window.addEventListener('mousemove', e=>{
  if(!drag) return;
  yaw   += (e.clientX-drag[0])*0.008;
  pitch += (e.clientY-drag[1])*0.008;
  pitch = Math.max(-1.5, Math.min(1.5, pitch));
  drag=[e.clientX,e.clientY]; if(last) draw(last);});
cv0.addEventListener('wheel', e=>{
  dist *= Math.exp(e.deltaY*0.001);
  dist = Math.max(0.3, Math.min(100, dist));
  e.preventDefault(); if(last) draw(last);},{passive:false});
let last = null;
async function tick(){
  try{
    const s = await (await fetch('/status')).json();
    document.getElementById('status').textContent = s.line;
    document.getElementById('loc').classList.toggle('on', s.localization);
    document.getElementById('frame').src = '/frame.png?'+s.n;
    const m = await (await fetch('/map.json')).json();
    last = m; draw(m);
  }catch(e){}
  setTimeout(tick, 200);
}
// Hand-rolled 3D view (replaces the reference's Pangolin OpenGlRenderState,
// src/MapDrawer.cc:21-198): orbit camera around `target`, perspective
// projection, painter-free wireframes.
function proj(p){
  const cy=Math.cos(yaw), sy=Math.sin(yaw);
  const cp=Math.cos(pitch), sp=Math.sin(pitch);
  let x=p[0]-target[0], y=p[1]-target[1], z=p[2]-target[2];
  let x1 =  cy*x + sy*z,  z1 = -sy*x + cy*z;      // yaw about Y
  let y2 =  cp*y - sp*z1, z2 =  sp*y + cp*z1;     // pitch about X
  const zc = z2 + dist;
  if (zc < 0.05) return null;
  const f = 420;
  return [cv0.width/2 + f*x1/zc, cv0.height/2 + f*y2/zc];
}
function seg(g, a, b){
  const pa = proj(a), pb = proj(b);
  if(!pa || !pb) return;
  g.moveTo(pa[0], pa[1]); g.lineTo(pb[0], pb[1]);
}
function frustum(g, fr){   // fr = [apex, c0, c1, c2, c3]
  g.beginPath();
  for(let i=1;i<=4;i++) seg(g, fr[0], fr[i]);
  seg(g, fr[1], fr[2]); seg(g, fr[2], fr[4]);
  seg(g, fr[4], fr[3]); seg(g, fr[3], fr[1]);
  g.stroke();
}
function draw(m){
  const g = cv0.getContext('2d');
  g.fillStyle='#000'; g.fillRect(0,0,cv0.width,cv0.height);
  if(follow && m.cur){target = m.cur;}
  else if(m.kfs.length){let s=[0,0,0];
    for(const k of m.kfs){s[0]+=k[0];s[1]+=k[1];s[2]+=k[2];}
    target=[s[0]/m.kfs.length, s[1]/m.kfs.length, s[2]/m.kfs.length];}
  g.fillStyle='#bbb';
  for(const p of m.pts){const q=proj(p); if(q) g.fillRect(q[0]-1,q[1]-1,2,2);}
  const styles = {c:'#36c', t:'#777', l:'#e33'};
  for(const kind of ['c','t','l']){
    g.strokeStyle = styles[kind];
    g.lineWidth = kind==='l' ? 2 : 1;
    g.beginPath();
    for(const e of m.edges){
      if(e[2]===kind) seg(g, m.kfs[e[0]], m.kfs[e[1]]);}
    g.stroke();
  }
  g.strokeStyle='#48f'; g.lineWidth=1;
  for(const fr of m.frusta){frustum(g, fr);}
  if(m.cur_frustum){g.strokeStyle='#4e4'; g.lineWidth=2;
    frustum(g, m.cur_frustum);}
  // AR cubes (ViewerAR parity: user-inserted, world-anchored).
  const CE = [[0,1],[1,3],[3,2],[2,0],[4,5],[5,7],[7,6],[6,4],
              [0,4],[1,5],[2,6],[3,7]];
  g.strokeStyle='#e4e'; g.lineWidth=2;
  for(const cube of (m.cubes||[])){
    g.beginPath();
    for(const e of CE) seg(g, cube[e[0]], cube[e[1]]);
    g.stroke();
  }
}
tick();
</script></body></html>"""


def _round4(points) -> list:
    return [[round(float(v), 4) for v in p] for p in points]


class LiveViewer:
    """The reference's Viewer::Run window and menu (src/Viewer.cc:34-120)
    as a page on localhost: the annotated current frame (FrameDrawer), a 3D
    map with keyframe frusta and the covisibility, spanning-tree and loop
    edges (MapDrawer), the menu's toggles (follow camera, localization
    mode, reset) wired back into the System, AR cubes, and the map as a
    PLY download.

    Endpoints: `/` the page, `/frame.png`, `/status`, `/map.json`,
    `/map.ply`, `POST /cmd?action=toggle_localization|reset|insert_cube|
    clear_cubes`. port 0 takes a free port (self.port has it).
    """

    def __init__(self, system, port: int = 8765):
        import http.server
        import threading

        self.system = system
        self.n = 0
        self._png: Optional[bytes] = None
        self._line = "starting"
        self._mlock = threading.Lock()
        # The frame is annotated and encoded only while a client has
        # fetched /frame.png in the last 3 s: the first poll gets a
        # placeholder and arms the gate.
        self._frame_wanted_until = 0.0
        # User-inserted AR cubes, (centre f32[3], normal f32[3], size) in
        # world coordinates (ViewerAR's insert-cube command): drawn in the
        # frame and the map from every later pose.
        self.cubes: list = []
        self.cube_size = 0.1
        viewer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):  # no request log
                pass

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                try:
                    path = self.path.split("?")[0]
                    if path == "/":
                        self._send(200, "text/html", _LIVE_HTML.encode())
                    elif path == "/frame.png":
                        import time as _time
                        viewer._frame_wanted_until = _time.time() + 3.0
                        with viewer._mlock:
                            png = viewer._png
                        if png is None:
                            png = encode_png(np.zeros((8, 8), np.uint8))
                        self._send(200, "image/png", png)
                    elif path == "/status":
                        import json
                        body = json.dumps({
                            "line": viewer._line, "n": viewer.n,
                            "localization":
                                viewer.system.tracker.only_tracking,
                        }).encode()
                        self._send(200, "application/json", body)
                    elif path == "/map.json":
                        self._send(200, "application/json",
                                   viewer._map_json())
                    elif path == "/map.ply":
                        import tempfile
                        with tempfile.NamedTemporaryFile(
                                "r", suffix=".ply", delete=False) as tf:
                            name = tf.name
                        try:
                            export_map_ply(name, viewer.system.arena)
                            with open(name, "rb") as f:
                                data = f.read()
                        except Exception as e:  # noqa: BLE001
                            self._send(500, "text/plain",
                                       f"export failed: {e}".encode())
                            return
                        finally:
                            try:
                                os.unlink(name)
                            except OSError:
                                pass
                        self._send(200, "application/octet-stream", data)
                    else:
                        self._send(404, "text/plain", b"not found")
                except (BrokenPipeError, ConnectionResetError):
                    pass

            def do_POST(self):
                try:
                    from urllib.parse import parse_qs, urlparse
                    q = parse_qs(urlparse(self.path).query)
                    action = q.get("action", [""])[0]
                    sys_ = viewer.system
                    if action == "toggle_localization":
                        if sys_.tracker.only_tracking:
                            sys_.deactivate_localization_mode()
                        else:
                            sys_.activate_localization_mode()
                    elif action == "reset":
                        sys_.reset()
                    elif action == "insert_cube":
                        ok = viewer.insert_cube()
                        self._send(200 if ok else 409, "text/plain",
                                   b"ok" if ok else b"no plane")
                        return
                    elif action == "clear_cubes":
                        viewer.cubes.clear()
                    self._send(200, "text/plain", b"ok")
                except (BrokenPipeError, ConnectionResetError):
                    pass

        self._server = http.server.ThreadingHTTPServer(
            ("127.0.0.1", port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="live_viewer")
        self._thread.start()

    def update(self, img: Optional[np.ndarray] = None):
        """Once per tracked frame (the Viewer::Run cadence): the status
        line, and, while a client polls /frame.png, the annotated frame."""
        import time as _time
        sys_ = self.system
        tr = sys_.tracker
        cur = tr.current
        tracked, vo = _point_classes(cur)
        self._line = status_text(
            sys_.get_tracking_state(), sys_.arena.n_keyframes(),
            sys_.arena.n_points(), int((tracked & ~vo).sum()),
            n_vo=int(vo.sum()), localization=tr.only_tracking)
        if (img is not None and cur is not None
                and _time.time() < self._frame_wanted_until):
            try:
                if img.ndim == 3:
                    img = img.mean(axis=2)
                ann = annotate_frame(img, frame_xy(cur), tracked, vo_mask=vo,
                                     init_vis=tr.init_vis)
                if self.cubes and cur.Tcw is not None:
                    self._draw_cubes_rgb(ann, cur.Tcw)
                png = encode_png(ann)
                with self._mlock:
                    self._png = png
            except Exception:  # noqa: BLE001 - the viewer never stops SLAM
                pass
        self.n += 1

    def insert_cube(self) -> bool:
        """ViewerAR's insert-cube command: a RANSAC plane through the
        current frame's tracked map points (ViewerAR.cc DetectPlane) and a
        cube anchored on it in world coordinates. False where there is no
        plane (too few tracked points, degenerate geometry)."""
        from orb_slam_system_tpu_torch.models.ar import fit_plane
        arena = self.system.arena
        tr = self.system.tracker
        with arena.lock:
            cur = tr.current
            if cur is None:
                return False
            pts = []
            for k in np.nonzero((cur.mp_ids >= 0) & ~cur.outlier)[0]:
                mp = arena.mps.get(int(cur.mp_ids[k]))
                if mp is not None and not mp.bad:
                    pts.append(mp.pos)
            if len(pts) < 30:
                return False
            pts = np.stack(pts)
            fit = fit_plane(pts)
            if fit is None:
                return False
            n, d, mask = fit
            center = pts[mask].mean(0)
            # The cube stands on the camera's side of the plane.
            if cur.Tcw is not None and n @ (cur.camera_center() - center) < 0:
                n = -n
            self.cubes.append((center.astype(np.float32),
                               n.astype(np.float32), self.cube_size))
        return True

    def _draw_cubes_rgb(self, out: np.ndarray, Tcw: np.ndarray):
        """Every inserted cube projected into the annotated frame
        (ViewerAR's cube render, headless)."""
        from orb_slam_system_tpu_torch.models.ar import (CUBE_EDGES,
                                                         cube_vertices)
        K = self.system.cfg.camera.K
        for center, n, size in self.cubes:
            Xc = cube_vertices(center, n, size) @ Tcw[:3, :3].T + Tcw[:3, 3]
            if (Xc[:, 2] <= 0.05).any():
                continue
            uv = ((Xc[:, :2] / Xc[:, 2:3])
                  @ np.diag([K[0, 0], K[1, 1]]) + [K[0, 2], K[1, 2]])
            for a, b in CUBE_EDGES:
                _line(out, uv[a], uv[b], CUBE)
        return out

    @staticmethod
    def _frustum(Tcw: np.ndarray, size: float):
        """Camera wireframe in world coordinates, [apex, 4 image-plane
        corners] (reference MapDrawer::DrawKeyFrames, src/MapDrawer.cc:
        84-128: w = size, h = 0.75 w, z = 0.6 w)."""
        R = Tcw[:3, :3].T
        C = -R @ Tcw[:3, 3]
        w, h, z = size, 0.75 * size, 0.6 * size
        corners = np.array([[-w, -h, z], [w, -h, z], [-w, h, z], [w, h, z]],
                           np.float32)
        return _round4([C] + [C + R @ c for c in corners])

    def _map_json(self) -> bytes:
        """The 3D view's payload: points (at most ~2000), keyframe centres
        and frusta, the covisibility (weight >= 100, 'c'), spanning-tree
        ('t') and loop ('l') edges, the current camera and the cubes (the
        reference MapDrawer's GL view, src/MapDrawer.cc:21-198)."""
        import json

        from orb_slam_system_tpu_torch.models.ar import cube_vertices
        arena = self.system.arena
        vw = self.system.cfg.viewer
        with arena.lock:
            pts = [mp.pos for mp in arena.mps.values()]
            if len(pts) > 2000:
                pts = pts[:: len(pts) // 2000 + 1]
            kf_ids = sorted(arena.kfs)
            kfi = {k: i for i, k in enumerate(kf_ids)}
            kfs = [arena.kfs[k].camera_center() for k in kf_ids]
            frusta = [self._frustum(arena.kfs[k].Tcw, vw.keyframe_size)
                      for k in kf_ids]
            edges = []
            for k in kf_ids:
                kf = arena.kfs[k]
                for nb, wgt in kf.covis.items():
                    if wgt >= 100 and nb > k and nb in kfi:
                        edges.append((kfi[k], kfi[nb], "c"))
                if kf.parent >= 0 and kf.parent in kfi:
                    edges.append((kfi[k], kfi[kf.parent], "t"))
                for le in kf.loop_edges:
                    if le > k and le in kfi:
                        edges.append((kfi[k], kfi[le], "l"))
            cur = self.system.tracker.current
            cur_c = cur_fr = None
            if cur is not None and cur.Tcw is not None:
                cur_c = cur.camera_center().tolist()
                cur_fr = self._frustum(cur.Tcw, vw.camera_size)
        cubes = [_round4(cube_vertices(c, n, s)) for c, n, s in self.cubes]
        return json.dumps({
            "pts": _round4(pts), "kfs": _round4(kfs), "frusta": frusta,
            "edges": edges, "cur": cur_c, "cur_frustum": cur_fr,
            "cubes": cubes,
        }).encode()

    def snapshot_map(self, path: str):
        export_map_ply(path, self.system.arena)

    def shutdown(self):
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)


class StatsViewer:
    """A status line per frame and, every `every_n` frames with an
    `out_dir`, the annotated frame as a PGM (the headless Viewer::Run)."""

    def __init__(self, system, out_dir: Optional[str] = None,
                 every_n: int = 0):
        self.system = system
        self.out_dir = out_dir
        self.every_n = every_n
        self.n = 0

    def update(self, img: Optional[np.ndarray] = None):
        sys_ = self.system
        tr = sys_.tracker
        cur = tr.current
        tracked, vo = _point_classes(cur)
        print(status_text(sys_.get_tracking_state(), sys_.arena.n_keyframes(),
                          sys_.arena.n_points(), int((tracked & ~vo).sum()),
                          n_vo=int(vo.sum()), localization=tr.only_tracking),
              flush=True)
        if (self.out_dir and img is not None and self.every_n
                and self.n % self.every_n == 0 and cur is not None):
            ann = annotate_frame(img, frame_xy(cur), tracked, vo_mask=vo,
                                 init_vis=tr.init_vis)
            write_pgm(os.path.join(self.out_dir, f"frame_{self.n:05d}.pgm"),
                      ann[..., 1])  # grayscale PGM: the green channel
        self.n += 1

    def snapshot_map(self, path: str):
        export_map_ply(path, self.system.arena)
