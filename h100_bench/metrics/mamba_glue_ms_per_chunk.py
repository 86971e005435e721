"""mamba_glue_ms_per_chunk (ms/chunk, device trace): ``glue_ms_per_chunk``'s
reading (kernels without ``sesa::`` per chunk) in bs_mamba2's cell, where it
is everything but K8: the projections, the depthwise conv, the flips, pads
and transposes, SiLU, the gated norm, the 57-band loops, the STFTs, the
casts and the demix's overlap-add."""

from h100_bench.metrics.glue_ms_per_chunk import read  # noqa: F401
