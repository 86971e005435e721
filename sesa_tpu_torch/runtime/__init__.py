from sesa_tpu_torch.runtime.demix import DemixSpec, apply_tta, demix  # noqa: F401
