"""maxsim_roofline.qps (%, device_trace; layer: kernels, csrc/maxsim.cu):
the bound of the dense work that the batches of the steps traced whole
needed (each candidate's valid tokens read once, queries and answers;
every cell at 2 T M per valid doc token; at 3.35 TB/s and 67 TFLOP/s),
over the device seconds of the ``maxsim_kernel`` launches of those same
steps."""
from perfbench.harness.readers import kernel_roofline_pct


def read(run):
    return kernel_roofline_pct(run, "dense", "maxsim_kernel")
