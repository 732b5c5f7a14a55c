"""batch_occupancy.p95 (frac, program_counter; layer: engine): mean
``BatchRecord.occupancy`` (real requests / batch size) of the window's
batches."""
import numpy as np


def read(run):
    occ = [b.occupancy for b in run.batches]
    return float(np.mean(occ)) if occ else None
