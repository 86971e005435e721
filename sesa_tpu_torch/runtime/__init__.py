from sesa_tpu_torch.runtime.demix import (DemixJob, DemixSpec, apply_tta, demix,  # noqa: F401
                                          demix_start, upload_mix)
