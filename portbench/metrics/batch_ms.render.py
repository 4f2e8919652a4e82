"""Host ms a frame spends in ``Trainer.next_batch`` (``PoseAudioDataset``:
the frame's rays, audio window and pose on the card), from the benchmark's
``portbench.batch`` range around the call in the traced window."""

from portbench.metrics._shared import batch_ms


def read(ctx):
    return batch_ms(ctx)
