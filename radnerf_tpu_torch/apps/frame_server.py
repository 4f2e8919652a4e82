"""The interactive app, headless (counterpart of
``radnerf_tpu/apps/frame_server.py``; reference nerf/gui.py, NeRFGUI and
OrbitCamera).

``InteractiveApp`` runs the reference GUI's render loop (gui.py:553-565)
without a window: a training burst when ``training`` is on, two ASR steps
when playing with a ``StreamingASR`` (50 fps features for 25 fps video),
then a free-viewpoint frame through ``Trainer.test_gui``. Its controls are
the GUI's: orbit, scale and pan the camera, play or pause the audio-driven
sequence, the audio index, eye area and individual code, the depth mode and
the resolution scale (``downscale``). A static view keeps rendering
perturbed frames and averages them into its buffer, up to ``max_spp``.
Frames go to a callback, to numbered PNGs (``run``) or to a browser as an
MJPEG stream (``serve``).
"""

from __future__ import annotations

import math
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..data.rays import get_audio_features
from ..utils.image import write_png


class OrbitCamera:
    """Orbit camera in the NGP pose convention (gui.py:12-70)."""

    def __init__(self, W: int, H: int, r: float = 2.0, fovy: float = 60.0):
        from scipy.spatial.transform import Rotation

        self.W = W
        self.H = H
        self.radius = r
        self.fovy = fovy
        self.center = np.zeros(3, np.float32)
        self._Rot = Rotation
        self.rot = Rotation.from_matrix([[0, -1, 0], [0, 0, -1], [1, 0, 0]])
        self.up = np.array([1, 0, 0], np.float32)

    @property
    def pose(self) -> np.ndarray:
        res = np.eye(4, dtype=np.float32)
        res[2, 3] -= self.radius
        rot = np.eye(4, dtype=np.float32)
        rot[:3, :3] = self.rot.as_matrix()
        res = rot @ res
        res[:3, 3] -= self.center
        return res

    def update_pose(self, pose: np.ndarray):
        self.radius = float(np.linalg.norm(pose[:3, 3]))
        T = np.eye(4)
        T[2, 3] = -self.radius
        self.rot = self._Rot.from_matrix((pose @ np.linalg.inv(T))[:3, :3])

    def update_intrinsics(self, intrinsics):
        _, fl_y, cx, cy = intrinsics
        self.W = int(cx * 2)
        self.H = int(cy * 2)
        self.fovy = math.degrees(2 * math.atan2(self.H, 2 * fl_y))

    @property
    def intrinsics(self) -> np.ndarray:
        focal = self.H / (2 * math.tan(math.radians(self.fovy) / 2))
        return np.array([focal, focal, self.W // 2, self.H // 2])

    def orbit(self, dx: float, dy: float):
        side = self.rot.as_matrix()[:3, 0]
        rx = self._Rot.from_rotvec(self.up * math.radians(-0.01 * dx))
        ry = self._Rot.from_rotvec(side * math.radians(-0.01 * dy))
        self.rot = rx * ry * self.rot

    def scale(self, delta: float):
        self.radius *= 1.1 ** (-delta)

    def pan(self, dx: float, dy: float, dz: float = 0.0):
        self.center += 1e-4 * self.rot.as_matrix()[:3, :3] @ np.array([dx, dy, dz])


def _encode_jpeg(frame: np.ndarray) -> bytes:
    """An RGB frame in [0, 1] as JPEG bytes, through PIL or else cv2."""
    img = (frame * 255).astype(np.uint8)
    try:
        from PIL import Image
    except ImportError:
        import cv2

        ok, data = cv2.imencode(".jpg", np.ascontiguousarray(img[..., ::-1]))
        if not ok:
            raise RuntimeError("cv2 could not encode the frame as JPEG")
        return data.tobytes()
    import io

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG")
    return buf.getvalue()


class InteractiveApp:
    """The headless interactive loop (NeRFGUI, gui.py:73-565) over a port
    ``Trainer`` and a dataset (``poses``, ``intrinsics``, ``bg_img``,
    ``auds``, ``eye_area``, ``H``, ``W``); ``asr`` a ``StreamingASR`` whose
    windows drive the playing sequence."""

    def __init__(self, opt, trainer, dataset, frame_callback: Optional[Callable] = None,
                 asr=None):
        self.opt = opt
        self.trainer = trainer
        self.dataset = dataset
        self.frame_callback = frame_callback
        self.asr = asr

        self.W = dataset.W
        self.H = dataset.H
        self.cam = OrbitCamera(opt.W, opt.H, r=opt.radius, fovy=opt.fovy)
        self.cam.update_intrinsics(dataset.intrinsics)
        self.cam.update_pose(np.asarray(dataset.poses[0]))

        bg = dataset.bg_img
        if bg.shape[0] != self.H or bg.shape[1] != self.W:
            import cv2

            bg = cv2.resize(bg, (self.W, self.H))
        # the background stays on the trainer's device for every frame
        self.bg_color = torch.as_tensor(bg, dtype=torch.float32,
                                        device=trainer.device).reshape(-1, 3)

        self.audio_features = dataset.auds
        self.audio_idx = 0
        self.eye_area = (float(np.mean(dataset.eye_area))
                         if getattr(dataset, "eye_area", None) is not None and opt.exp_eye
                         else None)
        self.ind_index = 0
        self.training = False
        self.playing = False
        self.train_steps = 16
        self._play_ptr = 0
        self.mode = "image"  # or "depth"
        self._stop = threading.Event()
        self.server = None
        self.serving = threading.Event()  # set once serve() listens
        self.fps = 0.0
        # progressive supersampling of a static view (gui.py:172-225): each
        # further frame is rendered perturbed (its spp as the seed) and
        # averaged in, up to max_spp
        self.downscale = 1.0
        self.max_spp = opt.max_spp
        self.spp = 1
        self.need_update = True
        self.render_buffer = None
        self._last_view_sig = None
        # bumped by set_bg_color: id() alone misses a buffer changed in place
        self._view_version = 0

    # -- camera controls (each invalidates the accumulation buffer) --------
    def orbit(self, dx: float, dy: float):
        self.cam.orbit(dx, dy)
        self.need_update = True

    def scale(self, delta: float):
        self.cam.scale(delta)
        self.need_update = True

    def pan(self, dx: float, dy: float, dz: float = 0.0):
        self.cam.pan(dx, dy, dz)
        self.need_update = True

    def set_bg_color(self, bg):
        """Replace the background (numpy or a tensor, [H*W, 3] or [H, W, 3]);
        the next frame starts a new accumulation."""
        self.bg_color = torch.as_tensor(bg, dtype=torch.float32,
                                        device=self.trainer.device).reshape(-1, 3)
        self._view_version += 1

    # -- one tick of the reference render loop (gui.py:553-565) ------------
    def step(self) -> np.ndarray:
        t0 = time.time()
        if self.training:
            self.trainer.train_gui(self.dataset, step=self.train_steps)
        if self.asr is not None and self.playing:
            # audio features at 50 fps, video at 25 fps: two ASR steps a frame
            for _ in range(2):
                self.asr.run_step()
        frame = self.render_frame()
        self.fps = 1.0 / max(time.time() - t0, 1e-9)
        if self.frame_callback is not None:
            self.frame_callback(frame)
        return frame

    def render_frame(self) -> np.ndarray:
        """The view as an [H, W, 3] float32 image in [0, 1]: a fresh frame
        when playing, training or after a control changed, else the next
        perturbed frame averaged into the buffer (until ``max_spp``)."""
        if self.playing:
            if self.asr is not None:
                auds = self.asr.get_next_feat()
            else:
                auds = get_audio_features(self.audio_features, self.opt.att, self._play_ptr)
                self._play_ptr = (self._play_ptr + 1) % len(self.audio_features)
        else:
            auds = (get_audio_features(self.audio_features, self.opt.att, self.audio_idx)
                    if self.audio_features is not None else None)

        if self.training or self.playing:
            self.need_update = True
        # a control that is a plain attribute invalidates the buffer through
        # the view's signature (the GUI's setters set need_update,
        # gui.py:226-320): a depth frame must not be averaged into an rgb
        # buffer, and a full buffer must not ignore a changed control
        view_sig = (self.mode, self.audio_idx, self.eye_area, self.ind_index, self.downscale,
                    id(self.bg_color), self._view_version)
        if view_sig != self._last_view_sig:
            if self._last_view_sig is not None:
                self.need_update = True
            self._last_view_sig = view_sig
        if not (self.need_update or self.spp < self.max_spp):
            return np.clip(self.render_buffer, 0.0, 1.0)

        out = self.trainer.test_gui(
            self.cam.pose, self.cam.intrinsics, self.W, self.H, auds=auds,
            eye=self.eye_area if self.eye_area is not None else 0.25, index=self.ind_index,
            bg_color=self.bg_color, spp=1 if self.need_update else self.spp,
            downscale=self.downscale)
        if self.mode == "depth":
            # world-unit depth (~3-4 at the working distance) would saturate
            # a plain clip: each frame is normalised to its own range, as the
            # trainer's depth PNGs are
            img = self.trainer._normalize_depth(out["depth"])[..., None].repeat(3, -1)
        else:
            img = out["image"]
        img = np.asarray(img, np.float32)
        if self.need_update:
            self.render_buffer = img
            self.spp = 1
            self.need_update = False
        else:
            self.render_buffer = (self.render_buffer * self.spp + img) / (self.spp + 1)
            self.spp += 1
        return np.clip(self.render_buffer, 0.0, 1.0)

    # -- the frame loops -----------------------------------------------------
    def run(self, max_frames: Optional[int] = None, save_dir: Optional[str] = None):
        """The frame loop, playing when there are audio features or an ASR;
        with ``save_dir`` each frame goes to ``frame_NNNNN.png``."""
        n = 0
        self.playing = self.audio_features is not None or self.asr is not None
        while not self._stop.is_set():
            frame = self.step()
            if save_dir is not None:
                write_png(f"{save_dir}/frame_{n:05d}.png", (frame * 255).astype(np.uint8))
            n += 1
            if max_frames is not None and n >= max_frames:
                break

    def stop(self):
        """End ``run`` and ``serve`` (from another thread)."""
        self._stop.set()
        if self.server is not None:
            self.server.shutdown()

    def serve(self, host: str = "127.0.0.1", port: int = 8965):
        """An MJPEG-over-HTTP frame server for a browser: ``/`` is a page
        showing ``/stream``, whose parts are JPEG frames, one ``step`` each.
        ``port`` 0 takes any free port (``self.server.server_address`` says
        which); blocks until ``stop``."""
        import http.server

        app = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path != "/stream":
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.end_headers()
                    self.wfile.write(b'<img src="/stream">')
                    return
                self.send_response(200)
                self.send_header("Content-Type", "multipart/x-mixed-replace; boundary=frame")
                self.end_headers()
                while not app._stop.is_set():
                    data = _encode_jpeg(app.step())
                    try:
                        self.wfile.write(b"--frame\r\nContent-Type: image/jpeg\r\n")
                        self.wfile.write(f"Content-Length: {len(data)}\r\n\r\n".encode())
                        self.wfile.write(data + b"\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        return  # the viewer went away

            def log_message(self, *a):
                pass

        server = http.server.ThreadingHTTPServer((host, port), Handler)
        self.server = server
        print(f"[frame-server] http://{host}:{server.server_address[1]}/", flush=True)
        self.serving.set()
        try:
            server.serve_forever()
        finally:
            server.server_close()
