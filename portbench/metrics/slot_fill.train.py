"""Share of the [N, S] sample slots the march writes that hold a kept
sample, over the traced window's training steps: the samples marched
(``n_samples_needed``) over rays x S, S each step's lattice width after the
adaptive capacities."""


def read(ctx):
    calls = (ctx.get("counts") or {}).get("samples") or []
    slots = sum(n * S for _, n, S in calls)
    if not slots:
        return None
    return 100.0 * sum(s for s, _, _ in calls) / slots
