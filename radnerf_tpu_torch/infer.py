"""Inference entry point of the port (the JAX package's ``infer.py``;
reference test.py): drive a trained avatar from a pose json and audio
features, on the card unless told otherwise:

    python -m radnerf_tpu_torch.infer --pose data/obama.json --aud data/intro_eo.npy \\
        --workspace trial_obama_torso/ -O --torso \\
        --ckpt trial_obama_torso/checkpoints/ngp.npz

    python -m radnerf_tpu_torch.infer --pose data/obama.json --workspace trial_obama_torso/ \\
        -O --torso --ckpt trial_obama_torso/checkpoints/ngp.npz --gui --asr --asr_wav speech.wav

In a program: ``main([...], device="cpu")``, which returns the FPS the
render measured. The test-mode smoothing (path, eye, lips) is on; ``-O``
renders under the bf16 policy. ``--gui`` serves the interactive app over the
poses as an MJPEG stream instead of writing a video, driven by streaming
speech features with ``--asr`` (then no ``--aud``); ``main(...,
logits_fn=f)`` gives it its acoustic model. ``--arch ernerf`` renders an
ER-NeRF checkpoint of the port (``main``'s flag).
"""

from __future__ import annotations

from .main import build_parser, float32_matmuls, live_app, options_from_args


def main(argv=None, device="cuda", logits_fn=None) -> float:
    from .data import PoseAudioDataset
    from .train import Trainer

    # the pose json is required; the training data is not
    parser = build_parser(require_path=False, prog="python -m radnerf_tpu_torch.infer")
    parser.add_argument("--pose", type=str, required=True, help="pose source json")
    args = parser.parse_args(argv)
    if not args.asr and not args.aud:
        parser.error("--aud is required unless --asr streaming is enabled")
    opt = options_from_args(args)
    opt.pose = args.pose
    opt.apply_test_mode()  # test.py:113-119 smooths at test
    float32_matmuls()

    trainer = Trainer(opt, device=device, name="ngp", workspace=opt.workspace,
                      use_checkpoint=opt.ckpt)
    dataset = PoseAudioDataset(opt, device=device)
    if opt.gui:
        app = live_app(opt, trainer, dataset, logits_fn)
        app.serve()  # the viewer at http://127.0.0.1:8965/
        return app.fps
    return trainer.test(dataset)


if __name__ == "__main__":
    main()
