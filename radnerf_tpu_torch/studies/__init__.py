"""Studies of the port's hand kernels on the card: attribution variants and
alternative designs timed in turns against the kernels on the path (none
of them is on it). ``python3 -m radnerf_tpu_torch.studies.grid_bf16``."""
