"""Model registry (counterpart of sesa_tpu/registry)."""

from sesa_tpu_torch.registry.models import (
    MODEL_CONFIGS,
    SUPPORTED_MODEL_TYPES,
    add_custom_model,
    conf_edit,
    delete_custom_model,
    detect_model_type_from_url,
    download_file,
    fix_huggingface_url,
    get_all_model_configs_with_custom,
    get_custom_models_list,
    get_model_chunk_size,
    get_model_config,
    load_custom_models,
    preprocess_yaml_content,
    validate_yaml_content,
)
