"""Newton iterations per batch: the largest of the (B,) counts that the
solve returns (the slowest pair holds the batch), as the mean over the
window's batches."""

import statistics


def read(rec):
    its = rec.get("batch_newton_max")
    return statistics.fmean(its) if its else None
