"""DeepSpeech audio features (the ``aud_ds.npy`` variant; counterpart of
``radnerf_tpu/preprocess/deepspeech.py``; reference
data_utils/deepspeech_features/).

The MFCC front-end (26 cepstra, BiRNN stride 2, +-9 frames of context,
global mean/std normalisation, deepspeech_features.py:200-238), the
50 fps -> video-fps linear interpolation (:241-274) and the 16-frame
stride-1 windowing with half-window zero padding (:112-180) are numpy on the
host, as in JAX (python_speech_features semantics). The acoustic network is
the DeepSpeech-0.1.0 TF frozen graph (``make_deepspeech_net_fn``, which
imports ``tensorflow`` and raises ImportError without it), or any injected
``net_fn(input_vector [T, 494]) -> [T, 1, 29]`` logits callable.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np


# --------------------------------------------------------------------- mfcc
def _framesig(signal, frame_len, frame_step):
    n = len(signal)
    if n <= frame_len:
        num_frames = 1
    else:
        num_frames = 1 + int(np.ceil((n - frame_len) / frame_step))
    pad = int((num_frames - 1) * frame_step + frame_len) - n
    padded = np.concatenate([signal, np.zeros(pad)])
    idx = (
        np.tile(np.arange(frame_len), (num_frames, 1))
        + np.tile(np.arange(0, num_frames * frame_step, frame_step), (frame_len, 1)).T
    )
    return padded[idx.astype(np.int32)]


def _hz2mel(hz):
    return 2595 * np.log10(1 + hz / 700.0)


def _mel2hz(mel):
    return 700 * (10 ** (mel / 2595.0) - 1)


def _filterbanks(nfilt, nfft, samplerate):
    low, high = _hz2mel(0), _hz2mel(samplerate / 2)
    melpoints = np.linspace(low, high, nfilt + 2)
    bins = np.floor((nfft + 1) * _mel2hz(melpoints) / samplerate).astype(int)
    fbank = np.zeros((nfilt, nfft // 2 + 1))
    for j in range(nfilt):
        for i in range(bins[j], bins[j + 1]):
            fbank[j, i] = (i - bins[j]) / max(bins[j + 1] - bins[j], 1)
        for i in range(bins[j + 1], bins[j + 2]):
            fbank[j, i] = (bins[j + 2] - i) / max(bins[j + 2] - bins[j + 1], 1)
    return fbank


def mfcc(signal: np.ndarray, samplerate: int = 16000, numcep: int = 26,
         winlen: float = 0.025, winstep: float = 0.01, nfilt: int = 26,
         nfft: int = 512, preemph: float = 0.97, ceplifter: int = 22):
    """MFCCs with python_speech_features default semantics."""
    from scipy.fftpack import dct

    signal = np.asarray(signal, np.float64)
    signal = np.append(signal[0], signal[1:] - preemph * signal[:-1])
    frames = _framesig(signal, int(winlen * samplerate), int(winstep * samplerate))
    pspec = (np.abs(np.fft.rfft(frames, nfft)) ** 2) / nfft
    energy = np.maximum(np.sum(pspec, 1), np.finfo(np.float64).eps)
    fb = _filterbanks(nfilt, nfft, samplerate)
    feat = np.maximum(pspec @ fb.T, np.finfo(np.float64).eps)
    feat = dct(np.log(feat), type=2, axis=1, norm="ortho")[:, :numcep]
    # liftering
    n = np.arange(numcep)
    lift = 1 + (ceplifter / 2.0) * np.sin(np.pi * n / ceplifter)
    feat = feat * lift
    # replace first cepstral coefficient with log frame energy
    feat[:, 0] = np.log(energy)
    return feat


# ------------------------------------------------------------ input vector
def audio_to_input_vector(audio: np.ndarray, sample_rate: int,
                          num_cepstrum: int = 26, num_context: int = 9):
    """MFCC -> DeepSpeech input windows [T, (2*ctx+1)*ncep]
    (deepspeech_features.py:183-238)."""
    features = mfcc(audio, samplerate=sample_rate, numcep=num_cepstrum)
    features = features[::2]  # BiRNN stride 2
    num_strides = len(features)
    empty = np.zeros((num_context, num_cepstrum), features.dtype)
    features = np.concatenate([empty, features, empty])
    window = 2 * num_context + 1
    out = np.stack(
        [features[i: i + window].reshape(-1) for i in range(num_strides)], 0
    )
    return (out - np.mean(out)) / np.std(out)


def interpolate_features(features, input_rate, output_rate, output_len):
    """Per-channel linear resampling (deepspeech_features.py:241-274)."""
    t_in = np.arange(features.shape[0]) / float(input_rate)
    t_out = np.arange(output_len) / float(output_rate)
    return np.stack(
        [np.interp(t_out, t_in, features[:, c]) for c in range(features.shape[1])], -1
    )


# ------------------------------------------------------------------ network
def make_deepspeech_net_fn(pb_path: str) -> Callable:
    """Frozen-graph runner (deepspeech_features.py:78-109); needs the
    published deepspeech-0_1_0 .pb file."""
    import tensorflow as tf

    graph_def = tf.compat.v1.GraphDef()
    with tf.io.gfile.GFile(pb_path, "rb") as f:
        graph_def.ParseFromString(f.read())
    graph = tf.Graph()
    with graph.as_default():
        tf.import_graph_def(graph_def, name="deepspeech")
    logits_ph = graph.get_tensor_by_name("deepspeech/logits:0")
    input_ph = graph.get_tensor_by_name("deepspeech/input_node:0")
    lengths_ph = graph.get_tensor_by_name("deepspeech/input_lengths:0")
    sess = tf.compat.v1.Session(graph=graph)

    def net_fn(input_vector: np.ndarray) -> np.ndarray:
        return sess.run(
            logits_ph,
            feed_dict={
                input_ph: input_vector[np.newaxis, ...],
                lengths_ph: [input_vector.shape[0]],
            },
        )

    return net_fn


# ----------------------------------------------------------------- pipeline
def extract_ds_features(
    wav_path: str,
    out_path: Optional[str] = None,
    pb_path: Optional[str] = None,
    net_fn: Optional[Callable] = None,
    num_frames: Optional[int] = None,
    window_size: int = 16,
    window_stride: int = 1,
) -> np.ndarray:
    """wav -> DeepSpeech feature windows [N, 16, 29], saved as ``out_path``
    (default: beside the wav as ``<stem>_ds.npy``, the ``aud_ds.npy`` that the
    datasets read for a deepspeech model; JAX writes ``<stem>.npy``)
    (extract_ds_features.py + pure_conv_audio_to_deepspeech,
    deepspeech_features.py:112-180)."""
    from ..apps.asr import load_wav

    if net_fn is None:
        if pb_path is None:
            raise ValueError("need a deepspeech .pb or an injected net_fn")
        net_fn = make_deepspeech_net_fn(pb_path)

    audio = load_wav(wav_path, 16000)
    input_vector = audio_to_input_vector((audio * 32767).astype(np.int16), 16000)
    logits = net_fn(input_vector)  # [T, 1, 29]

    fps = 50
    audio_len_s = len(audio) / 16000.0
    if num_frames is None:
        num_frames = int(round(audio_len_s * fps))
        video_fps = fps
    else:
        video_fps = num_frames / audio_len_s
    track = interpolate_features(logits[:, 0], fps, video_fps, num_frames)

    pad = np.zeros((window_size // 2, track.shape[1]))
    track = np.concatenate([pad, track, pad], 0)
    windows = np.stack(
        [track[i: i + window_size]
         for i in range(0, track.shape[0] - window_size, window_stride)], 0
    ).astype(np.float32)

    out_path = out_path or wav_path.replace(".wav", "_ds.npy")
    np.save(out_path, windows)
    return windows
