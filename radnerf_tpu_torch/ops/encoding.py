"""Encoder factory: a name -> (encode, output_dim, init).

Counterpart of ``radnerf_tpu/ops/encoding.py`` (reference
encoding.py:6-38). ``encode(x, params=None, bound=1.0)``; ``init(generator,
device)`` draws a grid's table U(-1e-4, 1e-4) from a ``torch.Generator``
onto the generator's device, or the card without one (``GridSpec.init``);
None for the encoders without parameters. "None" is the identity.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

from .freq_encode import freq_encode, freq_output_dim
from .grid_encode import GridSpec, grid_encode
from .sh_encode import sh_encode, sh_output_dim


def get_encoder(
    encoding: str,
    input_dim: int = 3,
    multires: int = 6,
    degree: int = 4,
    num_levels: int = 16,
    level_dim: int = 2,
    base_resolution: int = 16,
    log2_hashmap_size: int = 19,
    desired_resolution: float = 2048,
    interpolation: str = "linear",
    align_corners: bool = False,
) -> Tuple[Callable, int, Optional[Callable]]:
    """Build an encoder by name: "None", "frequency", "spherical_harmonics",
    "hashgrid" or "tiledgrid"."""
    if encoding == "None" or encoding is None:
        return (lambda x, params=None, bound=1.0: x), input_dim, None

    if encoding == "frequency":
        return ((lambda x, params=None, bound=1.0: freq_encode(x, multires)),
                freq_output_dim(input_dim, multires), None)

    if encoding == "spherical_harmonics":
        return ((lambda x, params=None, bound=1.0: sh_encode(x, degree)),
                sh_output_dim(degree), None)

    if encoding in ("hashgrid", "tiledgrid"):
        spec = GridSpec.create(
            input_dim=input_dim, num_levels=num_levels, level_dim=level_dim,
            base_resolution=base_resolution, log2_hashmap_size=log2_hashmap_size,
            desired_resolution=desired_resolution,
            gridtype="hash" if encoding == "hashgrid" else "tiled",
            interpolation=interpolation, align_corners=align_corners)

        def encode(x, params=None, bound=1.0, _spec=spec):
            if params is None:
                raise ValueError("grid encoders need their table params")
            return grid_encode(x, params, _spec, bound)

        def init(generator=None, device=None, _spec=spec):
            return _spec.init(generator, device=device)

        encode.spec = spec  # the table layout, for callers that need it
        return encode, spec.output_dim, init

    raise NotImplementedError(f"unknown encoding: {encoding}")
