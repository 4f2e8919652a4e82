"""Preprocessing entry point of the port (the root ``process.py``; reference
data_utils/process.py), on the card unless told otherwise:

    python -m radnerf_tpu_torch.process data/obama/obama.mp4 \\
        --parsing_weights weights/79999_iter.pth \\
        --basis_path weights/3DMM_info.npy --keys_path weights/keys_info.npy \\
        --topology_path weights/topology_info.npy

runs the 9 tasks (1 audio extract, 2 audio features, 3 frame extract, 4 face
parsing, 5 background plate, 6 torso/gt split, 7 landmarks, 8 3DMM tracking,
9 transforms json) in the video's directory, or one of them with ``--task
N``. Tasks 1 and 3 need ``ffmpeg``, task 7 ``face_alignment``, task 2 an
acoustic model (wav2vec2 through ``transformers``; DeepSpeech through
``tensorflow`` and ``--deepspeech_pb``). In a program: ``main(argv,
logits_fn=f)`` on the card (``device="cpu"`` for the host), where
``logits_fn`` is task 2's acoustic model.
"""

from __future__ import annotations

import argparse

from .preprocess import run_pipeline


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m radnerf_tpu_torch.process")
    p.add_argument("path", help="video file; the dataset is built in its directory")
    p.add_argument("--task", type=int, default=-1,
                   help="-1 = all tasks, or a single task id 1..9")
    p.add_argument("--asr", type=str, default="wav2vec", choices=["wav2vec", "deepspeech"])
    p.add_argument("--asr_model", type=str,
                   default="cpierse/wav2vec2-large-xlsr-53-esperanto")
    p.add_argument("--parsing_weights", type=str, default="",
                   help="BiSeNet face-parsing checkpoint (task 4)")
    p.add_argument("--basis_path", type=str, default="",
                   help="LandmarkBasis npz or 3DMM_info.npy (task 8)")
    p.add_argument("--keys_path", type=str, default="",
                   help="keys_info.npy (only with the 3DMM_info.npy format)")
    p.add_argument("--topology_path", type=str, default="",
                   help="topology_info.npy: enables the photometric refinement stage of task 8")
    p.add_argument("--deepspeech_pb", type=str, default="",
                   help="DeepSpeech-0.1.0 frozen graph (task 2 with --asr deepspeech)")
    return p


def main(argv=None, device="cuda", logits_fn=None):
    """Run the CLI on ``argv`` (default ``sys.argv[1:]``) on ``device``.
    ``logits_fn``: task 2's acoustic model (waveform -> [T, audio_dim]
    logits, or DeepSpeech's input windows -> [T, 1, 29])."""
    args = build_parser().parse_args(argv)
    run_pipeline(
        args.path, task=args.task, asr=args.asr, asr_model=args.asr_model,
        parsing_weights=args.parsing_weights, basis_path=args.basis_path,
        keys_path=args.keys_path, topology_path=args.topology_path,
        deepspeech_pb=args.deepspeech_pb, asr_logits_fn=logits_fn, device=device,
    )


if __name__ == "__main__":
    main()
