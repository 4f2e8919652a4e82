"""Telemetry-driven capacity sizing (counterpart of
``radnerf_tpu/train/capacity.py``, shared by the trainer and one-shot
sizing passes).

``adapt_render_config`` turns a render's measured occupancy (``n_hit``,
``n_samples_needed``, ``n_max_count``, ``n_k_span``, the two-level march's
``n_groups_needed`` / ``n_group_max`` and ``n_torso_mask``) into a resized
``RenderConfig``, with the JAX package's buckets and hysteresis bands, so
that the port and the JAX trainer take the same sequence of configurations.

Of the seven fields it sizes, the renderer reads three: ``march_iters`` (K,
the orbit length), ``sample_slots`` (S, the lattice width) and
``march_group_slots`` (the two-level march's kept groups a ray). Kernels B
and B-grouped truncate the march at them exactly as JAX's marchers do. The
other four (``ray_capacity_frac``, ``sample_capacity_mult``,
``torso_capacity_frac``, ``march_group_mult``) size the JAX package's
compaction buffers. The port compacts with ``nonzero`` and drops no ray,
sample, group or torso pixel at any of them: it carries them so that the
sizing decisions stay JAX's, and so that a checkpoint records all seven.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..models.renderer import RenderConfig
from ..ops.marching import MARCH_GROUP

ray_capacity = RenderConfig.ray_capacity
sample_capacity = RenderConfig.sample_capacity

# the fields adapt_render_config sizes and a checkpoint's meta records
CAPACITY_FIELDS = ("ray_capacity_frac", "sample_capacity_mult", "march_iters",
                   "sample_slots", "torso_capacity_frac", "march_group_mult",
                   "march_group_slots")


def adapt_render_config(
    rc: RenderConfig,
    n_hit: int,
    n_needed: int,
    n_max: int,
    n_rays: int,
    occ_radius: float,
    n_torso: Optional[int] = None,
    n_groups: Optional[int] = None,
    n_group_max: Optional[int] = None,
    n_k_span: Optional[int] = None,
    headroom: float = 1.35,
    fresh: bool = False,
) -> Optional[RenderConfig]:
    """Return a resized RenderConfig, or None if no change is needed.

    - ray capacity: keep hits within [40%, 85%] of capacity (1/8 buckets,
      rounded up so growth is immediate, shrink only on big slack),
    - sample capacity: quarter-step mult covering needed samples with
      headroom (shrink only past a half-step of slack),
    - march orbit length: the measured widest window plus a margin, in
      buckets of 8 (grow at once, shrink past a band of 16); without
      telemetry the occupied-sphere diameter,
    - sample-lattice width: grow by 4 when the marcher saturates it, shrink
      on >= 4 slots of slack (buckets of 4; dt derives from max_steps alone
      and is untouched),
    - two-level march: kept-group buffer (quarter steps, at least 0.5) and
      kept groups a ray (buckets of 2, at most ceil(K / 4)),
    - torso pixel capacity: the 1/8-bucket rule on the torso mask count.

    ``fresh=True`` snaps every capacity straight to the measured want (a
    one-shot sizing pass from exhaustive telemetry, as JAX's bench.py
    makes); the default hysteresis bounds JAX's recompile churn during
    training.
    """
    frac = rc.ray_capacity_frac
    R = ray_capacity(n_rays, frac)
    want = min(1.0, (n_hit / n_rays) * headroom if n_rays else 1.0)
    want = max(0.125, -(-want * 8 // 1) / 8)  # round up to 1/8
    if fresh or want > frac or (want < frac and n_hit < 0.4 * R):
        frac = want

    mult = rc.sample_capacity_mult
    r_for_mult = ray_capacity(n_rays, frac)
    used = n_needed / max(r_for_mult, 1)
    # quarter steps during training; 1/16 steps for a one-shot sizing
    step = 0.0625 if fresh else 0.25
    want_mult = max(step, -(-used * headroom / step // 1) * step)
    if fresh or want_mult > mult or want_mult < mult - 0.5:
        mult = want_mult

    march_iters = rc.march_iters
    dt_min = rc.march_config().dt_min
    k_step = 2 if fresh else 8
    if n_k_span is not None and n_k_span > 0:
        # the exact need: the widest per-ray marched window, measured
        want_k = int(-(-(n_k_span + 2) // k_step)) * k_step
    else:
        # no telemetry: a window's chord never exceeds the occupied sphere's
        # diameter
        want_k = int(-(-(2.0 * occ_radius / dt_min + 2) // 8)) * 8
    full_k = dataclasses.replace(rc, march_iters=None).march_config().n_march_iters
    want_k = min(want_k, full_k)
    # grow at once (an orbit shorter than the span truncates windows);
    # shrink only past a wide band
    if (fresh or march_iters is None or want_k > march_iters
            or want_k < march_iters - 16):
        march_iters = want_k

    slots = rc.sample_slots if rc.sample_slots is not None else rc.max_steps
    if fresh:
        # one safety slot, buckets of 2
        slots = min(rc.max_steps, max(4, int(-(-(n_max + 1) // 2)) * 2))
    elif n_max >= slots and slots < rc.max_steps:
        slots = min(rc.max_steps, slots + 4)
    elif n_max + 1 <= slots - 4:
        slots = max(4, int(-(-(n_max + 1) // 4)) * 4)

    # two-level march capacities (only when enabled and measured)
    g_mult = rc.march_group_mult
    g_slots = rc.march_group_slots
    if rc.march_group and n_groups is not None:
        used_g = n_groups / max(r_for_mult, 1)
        want_g = max(0.5, -(-used_g * headroom / 0.25 // 1) * 0.25)
        if fresh or want_g > g_mult or want_g < g_mult - 0.5:
            g_mult = want_g
    if rc.march_group and n_group_max is not None:
        # n_group_max is the true per-ray need (counted before truncation)
        kg = -(-(march_iters if march_iters is not None
                 else rc.march_config().n_march_iters) // MARCH_GROUP)
        cur_gs = g_slots if g_slots is not None else kg
        want_gs = min(kg, max(2, int(-(-(n_group_max + 1) // 2)) * 2))
        if fresh or want_gs > cur_gs or want_gs < cur_gs - 2:
            g_slots = want_gs

    t_frac = rc.torso_capacity_frac
    if n_torso is not None and rc.torso:
        cur = t_frac if t_frac is not None else frac
        want_t = min(1.0, (n_torso / n_rays) * headroom if n_rays else 1.0)
        want_t = max(0.125, -(-want_t * 8 // 1) / 8)
        T_cap = ray_capacity(n_rays, cur)
        if fresh or want_t > cur or (want_t < cur and n_torso < 0.4 * T_cap):
            t_frac = want_t

    if (frac != rc.ray_capacity_frac or mult != rc.sample_capacity_mult
            or march_iters != rc.march_iters or slots != rc.sample_slots
            or t_frac != rc.torso_capacity_frac
            or g_mult != rc.march_group_mult
            or g_slots != rc.march_group_slots):
        return dataclasses.replace(
            rc, ray_capacity_frac=frac, sample_capacity_mult=mult,
            march_iters=march_iters, sample_slots=slots,
            torso_capacity_frac=t_frac,
            march_group_mult=g_mult, march_group_slots=g_slots,
        )
    return None


def fresh_render_config(rc: RenderConfig, telemetry, n_rays: int, occ_radius: float,
                        headroom: float = 1.1) -> RenderConfig:
    """One-shot sizing of a static scene's capacities (JAX bench.py:170-214):
    a ``fresh`` pass on the telemetry of a render at ``rc``, then a second
    on a render at that result, which also sizes the two-level march's
    capacities (the first render's generous K keeps it dense). JAX renders
    its first pass on a smaller probe frame, as its generous lattice does
    not fit its device at full size; here both passes take the full frame.

    ``telemetry(cfg)`` renders the frame at ``cfg`` and returns its ``n_*``
    counts as ints (``n_hit``, ``n_samples_needed``, ``n_max_count``,
    ``n_k_span``, ``n_torso_mask``, ``n_groups_needed``, ``n_group_max``).
    K and S come out at the measured span and count plus their margins, so
    the frame at the result marches the same samples as at ``rc``, unless
    ``rc`` itself truncated it."""
    t = telemetry(rc)
    rc2 = adapt_render_config(rc, t["n_hit"], t["n_samples_needed"], t["n_max_count"],
                              n_rays, occ_radius, n_torso=t.get("n_torso_mask"),
                              n_k_span=t["n_k_span"], headroom=headroom, fresh=True) or rc
    t = telemetry(rc2)
    return adapt_render_config(rc2, t["n_hit"], t["n_samples_needed"], t["n_max_count"],
                               n_rays, occ_radius, n_torso=t.get("n_torso_mask"),
                               n_groups=t.get("n_groups_needed") or None,
                               n_group_max=t.get("n_group_max") or None,
                               n_k_span=t["n_k_span"], headroom=headroom, fresh=True) or rc2
