"""The viewer (port of the JAX package's viewer.py): dynamic resolution over
a few resolution rungs, foveated views, an HTTP orbit viewer and an
offline orbit benchmark.

- `FrameController`: the dynamic-resolution controller of
  utils/dynamic_res.py, its factor snapped to one of a few rungs, so that
  a frame loop renders at a few fixed shapes.
- `render_view`: one camera's frame through a Session, optionally
  foveated: a smaller grid of rays, dense at the screen centre (the
  piecewise-quadratic Foveation warp), is rendered as a ray batch (live
  rays through NerfEngine.render_rays, or baked rays through
  render_rays_baked and its G2 gathers) and resampled bilinearly to the
  display's pixels on the session's device.
- `serve`: an HTTP server of the standard library with an orbit camera:
  `/` returns a canvas page (drag orbits, the wheel dollies), `/frame?...`
  renders a view and returns it as PNG (io/png.py) with timing headers.
  `make_server` builds the server without starting it.
- `orbit_benchmark`: an offline orbit that holds a frame time by moving
  between the rungs, and logs each frame.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from sienerf_torch.io.png import encode_png, write_png
from sienerf_torch.utils.camera import look_at_matrix, uv_to_ray
from sienerf_torch.utils.dynamic_res import DynamicResController, Foveation


@dataclass
class FrameController:
    """Dynamic resolution over rungs: `rungs` are descending resolution
    factors of (base_w, base_h); `update` feeds a frame's ms to the
    controller and snaps its factor to the nearest rung."""

    base_w: int
    base_h: int
    target_ms: float = 100.0
    rungs: tuple = (1.0, 0.5, 0.25, 0.125)
    ctrl: DynamicResController = field(init=False)
    rung: float = field(init=False)

    def __post_init__(self):
        self.ctrl = DynamicResController(target_ms=self.target_ms, min_factor=min(self.rungs))
        self.rung = max(self.rungs)

    def update(self, measured_ms: float) -> float:
        f = self.ctrl.update(measured_ms)
        self.rung = min(self.rungs, key=lambda r: abs(r - f))
        return self.rung

    def resolution(self) -> tuple[int, int]:
        w = max(32, int(self.base_w * self.rung) // 16 * 16)
        h = max(32, int(self.base_h * self.rung) // 16 * 16)
        return w, h


def orbit_camera(center, radius: float, theta: float, phi: float) -> np.ndarray:
    """The (3, 4) camera on a sphere of `radius` around `center`, looking at
    it: theta the azimuth, phi the elevation (0 at the equator), radians."""
    c = np.asarray(center, np.float32)
    eye = c + radius * np.array(
        [np.cos(phi) * np.cos(theta), np.sin(phi), np.cos(phi) * np.sin(theta)], np.float32)
    return look_at_matrix(eye, c)


def _sync(session) -> None:
    """Wait for the session's device, so that a host clock reads a frame's
    whole time."""
    if getattr(session, "device", torch.device("cpu")).type == "cuda":
        torch.cuda.synchronize()


def render_view(session, camera, width: int, height: int, foveation_density: float = 1.0,
                **kw) -> torch.Tensor:
    """One view -> (H, W, 4) f32 on the session's device.  `focal` in kw,
    else training view 0's scaled to `width`.  With foveation_density <= 1
    it is Session.render (kw passed on).  Above 1, a grid of about
    1/foveation_density of the pixels (each side a multiple of 16, at
    least 32) is cast at the unwarped positions of its cells and rendered
    as one ray batch, renderer "live" (NerfEngine.render_rays) or "baked"
    (render_rays_baked on the session's bake, made with Session.bake's
    defaults if there is none); then each display pixel takes the bilinear
    blend of the render-space grid at its warped position."""
    focal = kw.pop("focal", None)
    if focal is None:
        eng = session.engine
        focal = tuple(np.asarray(eng.focals[0]) * width / eng.resolution[0])
    if foveation_density <= 1.0:
        return session.render(width, height, camera, focal, **kw)

    from sienerf_torch.engines.nerf_baked import render_rays_baked

    renderer = kw.pop("renderer", "live")
    if renderer not in ("live", "baked"):
        raise ValueError(f"a foveated view renders live or baked rays, not {renderer!r}")
    eng = session.engine
    dev = session.device
    fov = Foveation(density=foveation_density, center=0.5)
    rw = max(32, int(width / np.sqrt(foveation_density)) // 16 * 16)
    rh = max(32, int(height / np.sqrt(foveation_density)) // 16 * 16)
    # render-space cell centres -> display-space uv, dense at the centre
    ur = fov.unwarp((np.arange(rw) + 0.5) / rw)
    vr = fov.unwarp((np.arange(rh) + 0.5) / rh)
    uu, vv = np.meshgrid(ur, vr, indexing="xy")
    uv = torch.from_numpy(np.stack([uu, vv], axis=-1).reshape(-1, 2).astype(np.float32)).to(dev)
    with torch.no_grad():
        o, d = uv_to_ray(uv, (width, height), focal, np.asarray(camera, np.float32))
        params = session.render_params()
        bitfield = session.state["occ"]["bitfield"]
        min_t = kw.get("min_transmittance")
        if renderer == "baked":
            if session._baked is None:
                session.bake()
            grid, meta = session._baked
            rgb, op, _ = render_rays_baked(eng, params, grid, meta, bitfield, o, d,
                                           min_transmittance=min_t)
        else:
            rgb, op, _ = eng.render_rays(params, bitfield, o, d, min_transmittance=min_t)
        img = torch.cat([rgb, op[:, None]], dim=-1).reshape(rh, rw, 4).double()
        # display pixel -> render-space coordinates, bilinear
        ud = fov.warp((np.arange(width) + 0.5) / width) * rw - 0.5
        vd = fov.warp((np.arange(height) + 0.5) / height) * rh - 0.5
        x0 = np.clip(np.floor(ud).astype(np.int64), 0, rw - 2)
        y0 = np.clip(np.floor(vd).astype(np.int64), 0, rh - 2)
        fx = torch.from_numpy(np.clip(ud - x0, 0, 1)).to(dev)[None, :, None]
        fy = torch.from_numpy(np.clip(vd - y0, 0, 1)).to(dev)[:, None, None]
        xi, yi = torch.from_numpy(x0).to(dev), torch.from_numpy(y0).to(dev)
        rows0, rows1 = img[yi], img[yi + 1]
        a, b = rows0[:, xi], rows0[:, xi + 1]
        c, e = rows1[:, xi], rows1[:, xi + 1]
        out = a * (1 - fx) * (1 - fy) + b * fx * (1 - fy) + c * (1 - fx) * fy + e * fx * fy
    return out.float()


def _frame_bytes(rgba) -> np.ndarray:
    """A rendered frame (tensor or array) -> (H, W, 3) uint8, colour clipped
    to [0, 1] and truncated, as the JAX viewer quantises it."""
    if isinstance(rgba, torch.Tensor):
        rgba = rgba.detach().cpu().numpy()
    return (np.clip(np.asarray(rgba)[..., :3], 0, 1) * 255).astype(np.uint8)


_PAGE = """<!doctype html>
<html><head><title>sienerf viewer</title><style>
body{margin:0;background:#111;color:#ccc;font:12px monospace}
#hud{position:fixed;top:8px;left:8px;background:#0008;padding:6px}
canvas{display:block;margin:auto}
</style></head><body>
<div id="hud">drag: orbit &middot; wheel: dolly &middot; loading&hellip;</div>
<canvas id="c"></canvas><script>
let th=0.6, ph=0.3, r=2.2, busy=false, t0=0;
const cv=document.getElementById('c'), cx=cv.getContext('2d'),
      hud=document.getElementById('hud');
async function frame(){
  if(busy) return; busy=true; t0=performance.now();
  const res=await fetch(`/frame?theta=${th}&phi=${ph}&r=${r}`);
  const ms=res.headers.get('x-render-ms'), wh=res.headers.get('x-render-res');
  const blob=await res.blob(), img=await createImageBitmap(blob);
  cv.width=img.width; cv.height=img.height; cx.drawImageSmoothingEnabled=true;
  cx.drawImage(img,0,0);
  hud.textContent=`render ${wh} in ${ms} ms (net ${(performance.now()-t0)|0} ms)`;
  busy=false;
}
let drag=false,lx=0,ly=0;
cv.onmousedown=e=>{drag=true;lx=e.clientX;ly=e.clientY};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{if(!drag)return; th+=(e.clientX-lx)*0.01;
  ph=Math.max(-1.4,Math.min(1.4,ph+(e.clientY-ly)*0.01)); lx=e.clientX;ly=e.clientY; frame();};
window.onwheel=e=>{r=Math.max(0.3,r*(e.deltaY>0?1.1:0.9)); frame();};
frame(); setInterval(frame, 250);
</script></body></html>"""


def make_server(session, host: str = "127.0.0.1", port: int = 8060, width: int = 640,
                height: int = 360, target_ms: float = 250.0, center=(0.5, 0.5, 0.5),
                **render_kw):
    """The orbit viewer's ThreadingHTTPServer, bound and not yet serving
    (port 0 picks a free port: server.server_address has it).  Frames
    render one at a time, through render_view (render_kw passed on), at
    the FrameController's rung, which drops until frames meet
    `target_ms`."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    fc = FrameController(width, height, target_ms=target_ms)
    state = {"center": np.asarray(center, np.float32)}
    lock = threading.Lock()  # one frame at a time on the session

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, body: bytes, kind: str, headers=()):
            self.send_response(200)
            self.send_header("content-type", kind)
            self.send_header("content-length", str(len(body)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            u = urlparse(self.path)
            if u.path == "/":
                self._send(_PAGE.encode(), "text/html")
                return
            if u.path != "/frame":
                self.send_response(404)
                self.end_headers()
                return
            q = parse_qs(u.query)
            theta = float(q.get("theta", [0.6])[0])
            phi = float(q.get("phi", [0.3])[0])
            radius = float(q.get("r", [2.2])[0])
            cam = orbit_camera(state["center"], radius, theta, phi)
            with lock:
                w, h = fc.resolution()
                t0 = time.time()
                rgba = render_view(session, cam, w, h, **render_kw)
                _sync(session)
                ms = (time.time() - t0) * 1e3
                fc.update(ms)
            body = encode_png(_frame_bytes(rgba))
            self._send(body, "image/png", (("x-render-ms", f"{ms:.0f}"),
                                           ("x-render-res", f"{w}x{h}")))

    return ThreadingHTTPServer((host, port), Handler)


def serve(session, host: str = "127.0.0.1", port: int = 8060, width: int = 640,
          height: int = 360, target_ms: float = 250.0, center=(0.5, 0.5, 0.5), **render_kw):
    """Serve the orbit viewer until interrupted (make_server's server)."""
    srv = make_server(session, host, port, width, height, target_ms, center, **render_kw)
    print(f"viewer at http://{host}:{srv.server_address[1]}/  (ctrl-c to stop)")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()


def orbit_benchmark(session, n_frames: int = 24, width: int = 640, height: int = 360,
                    target_ms: float = 250.0, center=(0.5, 0.5, 0.5), radius: float = 2.2,
                    out_dir=None, **render_kw) -> list[dict]:
    """An orbit of n_frames views at elevation 0.3 that holds `target_ms` by
    moving between the FrameController's rungs -> the log of each frame
    {theta, w, h, ms, rung}.  With `out_dir`, each frame is written there
    as orbit_NNN.png."""
    fc = FrameController(width, height, target_ms=target_ms)
    logrows = []
    for i in range(n_frames):
        theta = 2 * np.pi * i / n_frames
        cam = orbit_camera(center, radius, theta, 0.3)
        w, h = fc.resolution()
        t0 = time.time()
        rgba = render_view(session, cam, w, h, **render_kw)
        _sync(session)
        ms = (time.time() - t0) * 1e3
        rung = fc.update(ms)
        logrows.append({"theta": round(theta, 3), "w": w, "h": h, "ms": round(ms, 1),
                        "rung": rung})
        if out_dir is not None:
            write_png(f"{out_dir}/orbit_{i:03d}.png", _frame_bytes(rgba))
    return logrows
