"""serve_mfu (%, program_counter; layer: whole step): operations the window's
answered requests needed (stage 1's 2 T (C L) M a query where the cell runs
it, revealed cells at 2 M L_i, every cell for dense) over the window's
seconds at the card's float32 peak of 67 TFLOP/s."""
from perfbench.harness.readers import mfu_pct


def read(run):
    return mfu_pct(run)
