"""Post-processing of separated stems (counterpart of sesa_tpu/postprocess):
ensembling and the phase fixer."""

from sesa_tpu_torch.postprocess.ensemble import (
    ENSEMBLE_METHODS,
    ensemble_files,
    ensemble_waveforms,
    ensemble_waveforms_device,
)
from sesa_tpu_torch.postprocess.phase_fixer import (
    ensemble_phase_fix_device,
    phase_fix_arrays,
    process_phase_fix,
)

__all__ = ["ENSEMBLE_METHODS", "ensemble_files", "ensemble_waveforms",
           "ensemble_waveforms_device", "ensemble_phase_fix_device", "phase_fix_arrays",
           "process_phase_fix"]
