"""flash_attention's share of its roofline over the traced window, in %,
for the kernels named in this metric's data file
(``readers.kernel_roofline``)."""
from portbench.readers import kernel_roofline


def read(obs, data):
    return kernel_roofline(obs, data["kernels"])
