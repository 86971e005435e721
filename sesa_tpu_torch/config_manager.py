"""Persisted user configuration: favourites, settings, presets (counterpart
of sesa_tpu/config_manager.py; reference config_manager.py:9-128). The
config directory is ``$SESA_TPU_HOME/config`` (default ``~/.sesa_tpu``); a
corrupt or wrongly shaped file heals to the defaults.
"""

from __future__ import annotations

import json
import os

CONFIG_DIR = os.path.join(os.environ.get("SESA_TPU_HOME", os.path.expanduser("~/.sesa_tpu")), "config")
CONFIG_FILE = os.path.join(CONFIG_DIR, "config.json")

DEFAULT_CONFIG = {
    "favorites": [],
    "settings": {
        "chunk_size": 352800,
        "overlap": 2,
        "export_format": "wav FLOAT",
        "compute_dtype": "bf16",
        "auto_use_tta": False,
        "use_tta": False,
        "use_demud_phaseremix_inst": False,
        "auto_extract_instrumental": False,
        "extract_instrumental": False,
        "use_apollo": False,
        "auto_use_apollo": False,
        "auto_apollo_chunk_size": 19,
        "auto_apollo_overlap": 2,
        "auto_apollo_method": "normal_method",
        "auto_apollo_normal_model": "Apollo Universal Model",
        "auto_apollo_midside_model": "Apollo Universal Model",
        "apollo_chunk_size": 19,
        "apollo_overlap": 2,
        "apollo_method": "normal_method",
        "apollo_normal_model": "Apollo Universal Model",
        "apollo_midside_model": "Apollo Universal Model",
        "use_matchering": False,
        "auto_use_matchering": False,
        "matchering_passes": 1,
        "auto_matchering_passes": 1,
        "model_category": "Vocal Models",
        "selected_model": None,
        "auto_category": "Vocal Models",
        "selected_models": [],
        "auto_ensemble_type": "avg_wave",
        "manual_ensemble_type": "avg_wave",
        "auto_category_dropdown": "Vocal Models",
        "manual_weights": "",
    },
    "presets": {},
}


def load_config() -> dict:
    os.makedirs(CONFIG_DIR, exist_ok=True)
    if not os.path.exists(CONFIG_FILE):
        with open(CONFIG_FILE, "w", encoding="utf-8") as f:
            json.dump(DEFAULT_CONFIG, f, indent=2)
        return json.loads(json.dumps(DEFAULT_CONFIG))
    try:
        with open(CONFIG_FILE, encoding="utf-8") as f:
            config = json.load(f)
        # wrong-shape (but valid) JSON self-heals like corrupt JSON does:
        # a top-level list or null/mistyped sections must not crash startup
        if not isinstance(config, dict):
            raise json.JSONDecodeError("not an object", "", 0)
        for key, value in DEFAULT_CONFIG.items():
            if isinstance(value, dict) and key in config and \
                    not isinstance(config[key], dict):
                del config[key]
    except json.JSONDecodeError:
        with open(CONFIG_FILE, "w", encoding="utf-8") as f:
            json.dump(DEFAULT_CONFIG, f, indent=2)
        return json.loads(json.dumps(DEFAULT_CONFIG))
    # merge-load so new keys appear in old configs (defaults are inserted
    # as deep COPIES so callers can never mutate DEFAULT_CONFIG itself)
    for key, value in DEFAULT_CONFIG.items():
        if key not in config:
            config[key] = json.loads(json.dumps(value))
        elif isinstance(value, dict):
            for subkey, subvalue in value.items():
                config[key].setdefault(
                    subkey, json.loads(json.dumps(subvalue))
                    if isinstance(subvalue, (dict, list)) else subvalue)
    return config


def save_config(favorites, settings, presets) -> None:
    os.makedirs(CONFIG_DIR, exist_ok=True)
    with open(CONFIG_FILE, "w", encoding="utf-8") as f:
        json.dump({"favorites": favorites, "settings": settings, "presets": presets},
                  f, indent=2)


def clean_model(model):
    """Remove the favorite star from a display name."""
    return model.replace(" ⭐", "") if isinstance(model, str) else model


def update_favorites(favorites, model, add=True):
    new = list(favorites)
    if add and model not in new:
        new.append(model)
    elif not add and model in new:
        new.remove(model)
    return new


def save_preset(presets, preset_name, models, ensemble_method, **kwargs):
    settings = load_config()["settings"]
    new = dict(presets)
    new[preset_name] = {
        "models": [clean_model(m) for m in models],
        "ensemble_method": ensemble_method,
        **{k: kwargs.get(k, settings.get(k)) for k in (
            "chunk_size", "overlap", "auto_use_tta", "auto_extract_instrumental",
            "use_apollo", "auto_apollo_chunk_size", "auto_category_dropdown",
            "auto_apollo_overlap", "auto_apollo_method", "auto_apollo_normal_model",
            "auto_apollo_midside_model", "auto_use_matchering",
            "auto_matchering_passes", "auto_category",
        )},
    }
    return new


def delete_preset(presets, preset_name):
    new = dict(presets)
    new.pop(preset_name, None)
    return new
