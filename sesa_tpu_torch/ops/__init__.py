"""Tensor operations of the port; the hand-written CUDA kernels sit behind
``attention.fused_attention_block`` (K1) and ``ff.fused_ff_residual`` (K2).

The package re-exports the names of ``sesa_tpu/ops/__init__.py``. As there,
``sesa_tpu_torch.ops.stft`` is then the function: import the module's other
names from ``sesa_tpu_torch.ops.stft``."""

from sesa_tpu_torch.ops.fft import irdft, rdft
from sesa_tpu_torch.ops.prec import net_precision
from sesa_tpu_torch.ops.stft import hann_window, istft, istft_ri, stft, stft_ri
from sesa_tpu_torch.ops.windows import fade_window
