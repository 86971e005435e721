"""Model zoo of the port: each model module exposes
``init(generator, config)``, ``apply(params, config, mix[B, ch, T], compute_dtype=None)``
and ``convert_torch(state_dict, config)``; dispatch by ``model_type`` string."""

from sesa_tpu_torch.models.registry import MODEL_TYPES, get_model  # noqa: F401
