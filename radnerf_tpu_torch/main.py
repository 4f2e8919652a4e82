"""Train / self-driven-test entry point of the port (the JAX package's
``main.py``; reference main.py), on the card unless told otherwise:

    python -m radnerf_tpu_torch.main data/obama/ --workspace trial_obama/ -O --iters 200000
    python -m radnerf_tpu_torch.main data/obama/ --workspace trial_obama/ -O --finetune_lips \\
        --iters 250000
    python -m radnerf_tpu_torch.main data/obama/ --workspace trial_obama_torso/ -O \\
        --torso --head_ckpt trial_obama/checkpoints/ngp.npz --iters 200000
    python -m radnerf_tpu_torch.main data/obama/ --workspace trial_obama_torso/ -O --torso --test
    python -m radnerf_tpu_torch.main data/obama/ --workspace trial_obama_torso/ -O --torso \\
        --test --gui --asr --asr_wav speech.wav

In a program: ``main([...], device="cpu")``, which returns the trainer.
Training runs train -> evaluate every ``eval_interval`` epochs (writing the
best checkpoint ``ngp.npz``) -> evaluate the test split -> render it to a
video; ``--test`` evaluates the test split when it has ground truth, then
renders it. The flags are ``main.py``'s. The capacity flags
(``--march_iters``, ``--sample_capacity_mult``, ``--ray_capacity_frac``)
start the capacities the trainer adapts, and a flag typed beats a
checkpoint's record, as in JAX; of them only ``--march_iters`` changes
what the port renders, which drops no work at the other two. ``-O``
(``--fp16 --exp_eye``) runs the bf16 policy (bf16 MLPs, grid encodes on
bf16 tables); ``--finetune_lips`` and ``--patch_size`` (>= 32)
train with the LPIPS term (its seeded, uncalibrated filters unless
``--lpips_weights`` names a file); ``--train_camera`` learns per-frame
camera offsets. ``--gui`` serves the interactive app (``apps/frame_server.py``)
as an MJPEG stream instead: over the test split with ``--test`` (driven by
streaming speech features with ``--asr``: a wav file given by ``--asr_wav``,
else the microphone), or training while it renders. ``main(...,
logits_fn=f)`` gives ``--asr`` its acoustic model (the default is wav2vec2,
``apps/asr.py``). ``--arch ernerf`` builds ER-NeRF's field (the tri-plane
hash encoding, region attention, adaptive pose encoding;
``models/network_triplane.py``) in the place of RAD-NeRF's: it renders an
ER-NeRF checkpoint of the port (``--test``, and ``infer``) in float32; its
training and ``-O`` are refused, and a checkpoint of the other field is
refused on load.
"""

from __future__ import annotations

import argparse
import dataclasses
import math

import torch

from .config import Options


def build_parser(require_path: bool = True,
                 prog: str = "python -m radnerf_tpu_torch.main") -> argparse.ArgumentParser:
    """main.py's flags; ``require_path=False`` makes the dataset directory
    optional (infer drives from a pose json instead)."""
    p = argparse.ArgumentParser(prog=prog)
    if require_path:
        p.add_argument("path", type=str)
    else:
        p.add_argument("path", type=str, nargs="?", default="")
    p.add_argument("-O", action="store_true", help="equals --fp16 --exp_eye")
    p.add_argument("--test", action="store_true")
    p.add_argument("--test_train", action="store_true")
    p.add_argument("--data_range", type=int, nargs="*", default=[0, -1])
    p.add_argument("--workspace", type=str, default="workspace")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--iters", type=int, default=200000)
    # the reference updates the EMA every 1000 steps (nerf/utils.py:578);
    # short runs need a shorter interval
    p.add_argument("--ema_update_interval", type=int, default=1000)
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--lr_net", type=float, default=5e-4)
    p.add_argument("--ckpt", type=str, default="latest")
    p.add_argument("--num_rays", type=int, default=4096 * 16)
    p.add_argument("--max_steps", type=int, default=16)
    p.add_argument("--update_extra_interval", type=int, default=16)
    p.add_argument("--max_ray_batch", type=int, default=4096)
    p.add_argument("--fp16", action="store_true")
    p.add_argument("--lambda_amb", type=float, default=0.1)
    p.add_argument("--bg_img", type=str, default="")
    p.add_argument("--exp_eye", action="store_true")
    p.add_argument("--fix_eye", type=float, default=-1)
    p.add_argument("--smooth_eye", action="store_true")
    p.add_argument("--torso_shrink", type=float, default=0.8)
    p.add_argument("--color_space", type=str, default="srgb")
    p.add_argument("--preload", type=int, default=0,
                   help="0: decode the frames at each batch, 1: keep them on the host, "
                        "2: on the device")
    p.add_argument("--bound", type=float, default=1.0)
    p.add_argument("--scale", type=float, default=4.0)
    p.add_argument("--offset", type=float, nargs="*", default=[0, 0, 0])
    p.add_argument("--dt_gamma", type=float, default=1 / 256)
    p.add_argument("--cull_T", type=float, default=1e-6)
    p.add_argument("--min_near", type=float, default=0.05)
    p.add_argument("--density_thresh", type=float, default=10)
    p.add_argument("--density_thresh_torso", type=float, default=0.01)
    p.add_argument("--patch_size", type=int, default=1)
    p.add_argument("--finetune_lips", action="store_true")
    p.add_argument("--smooth_lips", action="store_true")
    p.add_argument("--lpips_weights", type=str, default="",
                   help="LPIPS-alex calibration file (npz or torch) for the eval metric "
                        "and the lips/patch training term")
    p.add_argument("--torso", action="store_true")
    p.add_argument("--head_ckpt", type=str, default="")
    p.add_argument("--gui", action="store_true")
    p.add_argument("--W", type=int, default=450)
    p.add_argument("--H", type=int, default=450)
    p.add_argument("--radius", type=float, default=3.35)
    p.add_argument("--fovy", type=float, default=21.24)
    p.add_argument("--max_spp", type=int, default=1)
    p.add_argument("--att", type=int, default=2)
    p.add_argument("--aud", type=str, default="")
    p.add_argument("--emb", action="store_true")
    p.add_argument("--ind_dim", type=int, default=4)
    p.add_argument("--ind_num", type=int, default=10000)
    p.add_argument("--ind_dim_torso", type=int, default=8)
    p.add_argument("--amb_dim", type=int, default=2)
    p.add_argument("--part", action="store_true")
    p.add_argument("--part2", action="store_true")
    p.add_argument("--train_camera", action="store_true")
    p.add_argument("--smooth_path", action="store_true")
    p.add_argument("--smooth_path_window", type=int, default=7)
    p.add_argument("--asr", action="store_true")
    p.add_argument("--asr_wav", type=str, default="")
    p.add_argument("--asr_play", action="store_true")
    p.add_argument("--asr_model", type=str, default="cpierse/wav2vec2-large-xlsr-53-esperanto")
    p.add_argument("--asr_save_feats", action="store_true")
    p.add_argument("--fps", type=int, default=50)
    p.add_argument("-l", type=int, default=10)
    p.add_argument("-m", type=int, default=50)
    p.add_argument("-r", type=int, default=10)
    p.add_argument("--arch", type=str, default="radnerf", choices=("radnerf", "ernerf"),
                   help="the field: RAD-NeRF's (default) or ER-NeRF's tri-plane field "
                        "(rendering only, float32)")
    p.add_argument("--grid_levels", type=int, default=16,
                   help="multiresolution grid levels (reference: 16)")
    p.add_argument("--grid_ch", type=int, default=2,
                   help="feature channels per grid level (reference: 2)")
    p.add_argument("--grid_base", type=int, default=16,
                   help="coarsest grid resolution (reference: 16)")
    p.add_argument("--amb_grid_levels", type=int, default=None,
                   help="2-D (ambient and torso) grid levels; default --grid_levels")
    p.add_argument("--amb_grid_ch", type=int, default=None,
                   help="2-D grid channels per level (default --grid_ch)")
    p.add_argument("--amb_grid_base", type=int, default=None,
                   help="2-D grid coarsest resolution (default --grid_base)")
    # capacity flags: default None is a "not passed" sentinel; a flag the
    # user types is recorded in Options.cap_overrides and beats a
    # checkpoint's trained capacities, an unset one keeps the default and
    # restores from the checkpoint
    p.add_argument("--sample_capacity_mult", type=float, default=None,
                   help="JAX's field-eval buffer rows as a multiple of the compacted ray "
                        "count (default 4.0; adapted from telemetry unless set here; the "
                        "port drops no sample at it)")
    p.add_argument("--march_iters", type=int, default=None,
                   help="march orbit length K (default: the safe bound; adapted from "
                        "telemetry unless set here)")
    p.add_argument("--ray_capacity_frac", type=float, default=None,
                   help="JAX's occupied-box ray compaction capacity as a fraction of the "
                        "ray batch (default 1.0; adapted from telemetry unless set here; "
                        "the port drops no ray at it)")
    return p


# capacity flags whose provenance keeps them over a checkpoint's record
_CAP_FLAGS = ("sample_capacity_mult", "march_iters", "ray_capacity_frac")


def options_from_args(args) -> Options:
    """``Options`` from the parsed flags (main.py:150-177): the capacity
    flags typed are recorded in ``cap_overrides``, those not typed keep
    their defaults; -O and --test apply their bundles; lips finetune stops
    the grid upkeep."""
    fields = {f.name for f in dataclasses.fields(Options)}
    kw = {k: v for k, v in vars(args).items() if k in fields}
    kw["data_range"] = tuple(args.data_range)
    kw["offset"] = tuple(args.offset)
    kw["cap_overrides"] = tuple(f for f in _CAP_FLAGS if getattr(args, f, None) is not None)
    for f in _CAP_FLAGS:
        if kw.get(f) is None:
            kw.pop(f, None)
    opt = Options(**kw)
    if args.O:
        opt.apply_O()
    if args.test:
        opt.apply_test_mode()
    if opt.patch_size > 1 and opt.num_rays % (opt.patch_size**2) != 0:
        raise ValueError("patch_size ** 2 should divide num_rays")
    if opt.finetune_lips:
        # no density-grid upkeep during the lips finetune stage
        opt.update_extra_interval = 10**9
    return opt


def float32_matmuls():
    """The port's GEMMs as JAX computes them: TF32 off for cuDNN (the audio
    convs, LPIPS) and for matmuls, and no bf16 reduction of split-K partials
    in cuBLAS (the bf16 policy's MLPs sum in float32); ``render_rays``
    refuses either."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def eval_metrics(opt: Options, device, test: bool) -> list:
    """PSNR and LPIPS; in test mode also LMD where face_alignment is
    installed (main.py:189-199)."""
    from .train.metrics import LMDMeter, LPIPSMeter, PSNRMeter

    metrics = [PSNRMeter(), LPIPSMeter(weights_path=opt.lpips_weights, device=device)]
    if test:
        try:
            metrics.append(LMDMeter(backend="fan"))
        except ImportError as e:
            print(f"[WARN] LMD metric unavailable: {e}", flush=True)
    return metrics


def live_app(opt: Options, trainer, dataset, logits_fn=None):
    """The interactive app over ``dataset``; with ``opt.asr`` driven by a
    ``StreamingASR`` (acoustic model ``logits_fn``, default wav2vec2) that
    has warmed up."""
    from .apps import InteractiveApp, StreamingASR

    asr = None
    if opt.asr:
        asr = StreamingASR(opt, logits_fn=logits_fn, device=trainer.device)
        asr.warm_up()
    return InteractiveApp(opt, trainer, dataset, asr=asr)


def main(argv=None, device="cuda", logits_fn=None):
    """Run the CLI on ``argv`` (default ``sys.argv[1:]``) on ``device``;
    returns the trainer. ``logits_fn``: the acoustic model of ``--asr``."""
    from .data import TalkingHeadDataset
    from .train import Trainer

    args = build_parser().parse_args(argv)
    opt = options_from_args(args)
    if opt.arch == "ernerf" and not opt.test:
        from .models.network_triplane import TRAINING_REFUSED

        raise NotImplementedError(TRAINING_REFUSED)
    float32_matmuls()

    if opt.test:
        trainer = Trainer(opt, device=device, name="ngp", workspace=opt.workspace,
                          use_checkpoint=opt.ckpt,
                          metrics=[] if opt.gui else eval_metrics(opt, device, True))
        test_set = TalkingHeadDataset(opt, split="train" if opt.test_train else "test",
                                      device=device)
        test_set.training = False
        test_set.num_rays = -1
        if opt.gui:
            live_app(opt, trainer, test_set, logits_fn).serve()
            return trainer
        if test_set.has_gt:
            trainer.evaluate(test_set)
        trainer.test(test_set)
        return trainer

    train_ds = TalkingHeadDataset(opt, split="train", device=device)
    if len(train_ds) >= opt.ind_num:
        raise ValueError(f"dataset has {len(train_ds)} frames, increase --ind_num")
    # the last epoch always evaluates, so the best checkpoint (ngp.npz) exists
    max_epoch = math.ceil(opt.iters / len(train_ds))
    eval_interval = max(1, min(int(5000 / len(train_ds)), max_epoch))
    trainer = Trainer(opt, device=device, name="ngp", workspace=opt.workspace,
                      use_checkpoint=opt.ckpt, ema_decay=0.95,
                      metrics=eval_metrics(opt, device, False), eval_interval=eval_interval)
    if opt.torso and opt.head_ckpt:
        trainer.freeze_loaded_head(opt.head_ckpt)
    if opt.gui:
        from .apps import InteractiveApp

        app = InteractiveApp(opt, trainer, train_ds)
        app.training = True
        app.serve()
        return trainer
    valid_ds = TalkingHeadDataset(opt, split="val", device=device)
    trainer.log(f"[INFO] max_epoch = {max_epoch}")
    trainer.train(train_ds, valid_ds, max_epoch)

    test_ds = TalkingHeadDataset(opt, split="test", device=device)
    test_ds.training = False
    test_ds.num_rays = -1
    if test_ds.has_gt:
        trainer.evaluate(test_ds)
    trainer.test(test_ds)
    return trainer


if __name__ == "__main__":
    main()
