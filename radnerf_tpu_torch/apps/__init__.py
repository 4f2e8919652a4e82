"""The live path: the headless interactive app (orbit camera, frame loop,
MJPEG server) and the streaming speech features."""

from .asr import StreamingASR, load_wav, make_wav2vec_logits_fn, unfold_features
from .frame_server import InteractiveApp, OrbitCamera

__all__ = ["InteractiveApp", "OrbitCamera", "StreamingASR", "load_wav",
           "make_wav2vec_logits_fn", "unfold_features"]
