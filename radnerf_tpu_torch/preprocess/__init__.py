"""Offline preprocessing (video -> training dataset) on the card: BiSeNet
parsing, background and torso plates, the 3DMM tracker and its photometric
refinement (counterpart of ``radnerf_tpu/preprocess``)."""

from .pipeline import PreprocessPipeline, run_pipeline

__all__ = ["PreprocessPipeline", "run_pipeline"]
