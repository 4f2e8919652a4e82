"""Host ms a training step spends in ``Trainer.next_batch`` (the on-card
dataset's ray draw and gather), from the benchmark's ``portbench.batch``
range around the call in the traced window."""

from portbench.metrics._shared import batch_ms


def read(ctx):
    return batch_ms(ctx)
