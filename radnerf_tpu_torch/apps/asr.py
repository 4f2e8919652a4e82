"""Streaming speech features for the live path (counterpart of
``radnerf_tpu/apps/asr.py``; reference nerf/asr.py).

Audio at 16 kHz is consumed in 20 ms chunks (``sample_rate // fps``). A
sliding window of ``l + m + r`` chunks goes through a CTC acoustic model,
whose stride halves are cut from the logits, so the design latency is
``(m + r) * 20`` ms. The logits land in a circular queue of four
context-sized segments; ``get_next_feat`` assembles the renderer's
``[8, audio_dim, 16]`` attention window from it, two logit frames on per
video frame (50 fps audio, 25 fps video). With ``--asr_save_feats`` the whole
logit track is unfolded into ``[N, 16, C]`` training features.

The window and queue machinery is host control and stays numpy;
``get_next_feat`` hands the window to the renderer as a float32 tensor on
the trainer's device. The acoustic model is ``logits_fn`` (a float32
waveform window -> ``[T, audio_dim]`` logits): by default the HuggingFace
wav2vec2 model on the card (``make_wav2vec_logits_fn``, which needs the
``transformers`` package and the model's weights); any callable can be
given instead. File mode reads a wav through soundfile or scipy; the live
microphone and the playback echo need ``pyaudio``. Each missing package
raises ``ImportError``; nothing falls back to a stand-in.
"""

from __future__ import annotations

import time
from queue import Queue
from threading import Event, Thread
from typing import Callable, Optional

import numpy as np
import torch

from ..device import resolve_device


def load_wav(path: str, sample_rate: int = 16000) -> np.ndarray:
    """A wav file as float32 mono at ``sample_rate`` (linear resampling)."""
    try:
        import soundfile as sf

        stream, sr = sf.read(path)
    except ImportError:
        from scipy.io import wavfile

        sr, stream = wavfile.read(path)
        if stream.dtype == np.int16:
            stream = stream.astype(np.float32) / 32767
        elif stream.dtype == np.int32:
            stream = stream.astype(np.float32) / 2147483647
    stream = np.asarray(stream, np.float32)
    if stream.ndim > 1:
        stream = stream[:, 0]
    if sr != sample_rate:
        n_out = int(round(len(stream) * sample_rate / sr))
        x_old = np.linspace(0.0, 1.0, len(stream), endpoint=False)
        x_new = np.linspace(0.0, 1.0, n_out, endpoint=False)
        stream = np.interp(x_new, x_old, stream).astype(np.float32)
    return stream


def make_wav2vec_logits_fn(model_name: str, device="cuda") -> Callable:
    """The default CTC backend: the HuggingFace wav2vec2 model ``model_name``
    (a hub name or a local directory) on ``device`` (reference asr.py:93-96,
    323-328). Raises ImportError without the ``transformers`` package."""
    from transformers import AutoModelForCTC, AutoProcessor

    dev = resolve_device(device)
    processor = AutoProcessor.from_pretrained(model_name)
    model = AutoModelForCTC.from_pretrained(model_name).to(dev).eval()

    def logits_fn(frame: np.ndarray) -> np.ndarray:
        inputs = processor(frame, sampling_rate=16000, return_tensors="pt", padding=True)
        with torch.no_grad():
            logits = model(inputs.input_values.to(dev)).logits
        return logits[0].cpu().numpy()

    return logits_fn


def unfold_features(feats: np.ndarray, window_size: int = 16, stride: int = 2) -> np.ndarray:
    """Logit track [M, C] -> training features [(M + 2 * (window // 2) -
    window) // stride + 1, window, C], zero-padded by half a window at both
    ends (asr.py:236-247)."""
    M, C = feats.shape
    pad = window_size // 2
    padded = np.concatenate(
        [np.zeros((pad, C), feats.dtype), feats, np.zeros((pad, C), feats.dtype)], 0)
    n_out = (M + 2 * pad - window_size) // stride + 1
    out = np.stack([padded[i * stride: i * stride + window_size] for i in range(n_out)], 0)
    return out.astype(np.float32)


class StreamingASR:
    """Streaming feature extractor (reference ASR, asr.py:35-420).

    Args:
      opt: the options: ``asr_wav`` (file mode; empty: the microphone),
        ``asr_play``, ``fps``, ``l`` / ``m`` / ``r``, ``asr_model``,
        ``audio_in_dim``, ``asr_save_feats``.
      logits_fn: the acoustic model; None loads ``make_wav2vec_logits_fn``.
      decode_fn: optional CTC decoder of a window's logits to text.
      device: where ``get_next_feat`` puts the windows (and the default
        model runs); "cuda" by default, which raises without a card.
    """

    def __init__(self, opt, logits_fn: Optional[Callable] = None,
                 decode_fn: Optional[Callable] = None, device="cuda"):
        self.opt = opt
        self.device = resolve_device(device)
        self.play = opt.asr_play
        self.fps = opt.fps
        self.sample_rate = 16000
        self.chunk = self.sample_rate // self.fps  # 320 samples = 20 ms
        self.mode = "live" if opt.asr_wav == "" else "file"
        self.audio_dim = opt.audio_in_dim

        self.context_size = opt.m
        self.stride_left_size = opt.l
        self.stride_right_size = opt.r
        self.text = "[START]\n"
        self.terminated = False
        self.frames = []
        if self.stride_left_size > 0:
            self.frames.extend([np.zeros(self.chunk, np.float32)] * self.stride_left_size)

        self._logits_fn = logits_fn
        self._decode_fn = decode_fn
        self.exit_event = Event()

        self.audio_instance = None
        if self.mode == "live" or self.play:
            import pyaudio

            self.audio_instance = pyaudio.PyAudio()
        if self.mode == "file":
            self.file_stream = load_wav(opt.asr_wav, self.sample_rate)
        else:
            # the microphone: a reader thread feeds a queue (asr.py:15-23)
            self.input_stream = self.audio_instance.open(
                format=pyaudio.paInt16, channels=1, rate=self.sample_rate, input=True,
                frames_per_buffer=self.chunk)
            self.queue = Queue()
            self.reader = Thread(target=self._read_frames)
        if self.play:
            # the consumed audio echoed through an output stream fed by a
            # player thread (asr.py:77-85, 201), as int16 samples
            self.output_stream = self.audio_instance.open(
                format=pyaudio.paInt16, channels=1, rate=self.sample_rate, input=False,
                output=True, frames_per_buffer=self.chunk)
            self.output_queue = Queue()
            self.player = Thread(target=self._play_frames)
        self.idx = 0
        self.listening = False
        self.playing = False

        if self._logits_fn is None:
            self._logits_fn = make_wav2vec_logits_fn(opt.asr_model, self.device)

        self.save_feats = opt.asr_save_feats
        self.all_feats = []

        # a ring of four context-sized segments of logit frames covers every
        # 16-frame window the renderer asks for while the CTC head stays
        # ahead of playback (cf. asr.py:100-109)
        self.n_segments = 4
        self.seg_idx = 0
        self.feat_queue = np.zeros((self.n_segments * self.context_size, self.audio_dim),
                                   np.float32)
        # the first window reads across the ring's seam: its 8 frames before
        # t = 0 come from the (still zero) end of the ring, as if silence
        # preceded the stream
        self.read_lo = self.n_segments * self.context_size - 8
        self.read_hi = 8
        self.att_feats = [np.zeros((self.audio_dim, 16), np.float32)] * 4

        # steps before the first frame: one context of features, the right
        # stride the CTC window looks ahead, the attention's half window of
        # 8 frames, and 2 chunks of slack per extra window (asr.py:112)
        self.warm_up_steps = self.context_size + self.stride_right_size + 8 + 2 * 3

    # ---------------------------------------------------------------- audio io
    def _read_frames(self):
        while not self.exit_event.is_set():
            frame = self.input_stream.read(self.chunk, exception_on_overflow=False)
            self.queue.put(np.frombuffer(frame, np.int16).astype(np.float32) / 32767)

    def _play_frames(self):
        while True:
            frame = self.output_queue.get()
            if self.exit_event.is_set():
                return
            pcm = np.clip(frame * 32767.0, -32768, 32767).astype(np.int16)
            self.output_stream.write(pcm.tobytes())

    def listen(self):
        if self.mode == "live" and not self.listening:
            self.reader.start()
            self.listening = True
        if self.play and not self.playing:
            self.player.start()
            self.playing = True

    def stop(self):
        self.exit_event.set()
        if self.mode == "live" and self.listening:
            self.input_stream.stop_stream()
            self.input_stream.close()
            self.reader.join()
            self.listening = False
        if self.play and self.playing:
            # unblock the player's queue.get so that join returns, then close
            self.output_queue.put(np.zeros(self.chunk, np.float32))
            self.player.join()
            self.output_stream.stop_stream()
            self.output_stream.close()
            self.playing = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        if self.mode == "live":
            print(self.text + "\n[END]")

    def get_audio_frame(self) -> Optional[np.ndarray]:
        if self.mode == "file":
            if self.idx < self.file_stream.shape[0]:
                frame = self.file_stream[self.idx: self.idx + self.chunk]
                self.idx += self.chunk
                return frame
            return None
        frame = self.queue.get()
        self.idx += self.chunk
        return frame

    # ---------------------------------------------------------------- pipeline
    def get_next_feat(self) -> torch.Tensor:
        """The next ``[8, audio_dim, 16]`` attention window (asr.py:160-183)
        as the renderer takes it: float32 on the device."""
        Q = self.feat_queue.shape[0]
        while len(self.att_feats) < 8:
            if self.read_lo < self.read_hi:
                feat = self.feat_queue[self.read_lo: self.read_hi]
            else:
                feat = np.concatenate(
                    [self.feat_queue[self.read_lo:], self.feat_queue[: self.read_hi]], 0)
            self.read_lo = (self.read_lo + 2) % Q
            self.read_hi = (self.read_hi + 2) % Q
            self.att_feats.append(feat.T.copy())
        att = np.stack(self.att_feats, 0)
        self.att_feats = self.att_feats[1:]
        return torch.from_numpy(att).to(self.device)

    def run_step(self):
        """Consume one 20 ms chunk; run the CTC window once it is full
        (asr.py:185-251)."""
        if self.terminated:
            return
        frame = self.get_audio_frame()
        if frame is None:
            self.terminated = True
        else:
            self.frames.append(frame)
            if self.play:
                self.output_queue.put(frame)
            need = self.stride_left_size + self.context_size + self.stride_right_size
            if len(self.frames) < need:
                return

        inputs = np.concatenate(self.frames)
        if not self.terminated:
            self.frames = self.frames[-(self.stride_left_size + self.stride_right_size):]

        logits = self._logits_fn(inputs)  # [T, audio_dim]
        # cut the stride halves (asr.py:330-338)
        left = max(0, self.stride_left_size)
        right = min(logits.shape[0], logits.shape[0] - self.stride_right_size + 1)
        if self.terminated:
            right = logits.shape[0]
        feats = logits[left:right]

        if self._decode_fn is not None:
            text = self._decode_fn(feats)
            if text:
                self.text += " " + text

        if self.save_feats:
            self.all_feats.append(feats)

        if not self.terminated:
            start = self.seg_idx * self.context_size
            end = start + feats.shape[0]
            self.feat_queue[start:end] = feats[: self.feat_queue.shape[0] - start]
            self.seg_idx = (self.seg_idx + 1) % self.n_segments

        if self.terminated and self.save_feats:
            out = unfold_features(np.concatenate(self.all_feats, 0))
            suffix = "_eo.npy" if "esperanto" in self.opt.asr_model else ".npy"
            output_path = self.opt.asr_wav.replace(".wav", suffix)
            np.save(output_path, out)
            print(f"[INFO] saved logits to {output_path}")

    def run(self):
        self.listen()
        while not self.terminated:
            self.run_step()

    def clear_queue(self):
        if self.mode == "live":
            self.queue.queue.clear()
        if self.play:
            self.output_queue.queue.clear()

    def warm_up(self):
        self.listen()
        print(f"[INFO] warm up ASR, expected latency = {self.warm_up_steps / self.fps:.4f}s")
        t = time.time()
        for _ in range(self.warm_up_steps):
            self.run_step()
        print(f"[INFO] warm-up done, actual latency = {time.time() - t:.4f}s")
        self.clear_queue()
