"""Pretrained-model registry: 121 community checkpoints + custom models
(counterpart of sesa_tpu/registry/models.py; reference model.py:15-530,
1769-1880): name -> (model_type, config, checkpoint) resolution with
on-demand download, HuggingFace /blob/ -> /resolve/ URL fixing,
HTML-masquerade detection for YAML and checkpoints, YAML repair (tabs,
unquoted URLs and Windows paths) with backup and restore, a conf_edit that
patches inference overlap and batch while keeping the model's native
chunk_size, and a JSON-backed custom-model CRUD.

The registry data is ``model_registry.json``, a copy of the JAX package's.
``yaml`` and ``requests`` are imported only inside the functions that use
them: a ``.json`` config is read and patched with ``json``, and a ``.yaml``
config without pyyaml raises the error ``configs.load_config`` raises.
Downloaded Python is never executed (``bs_roformer_custom`` entries are
resolved declaratively from their config).
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Dict, Optional, Tuple
from urllib.parse import quote

_HERE = os.path.dirname(os.path.abspath(__file__))
BASE_DIR = os.environ.get("SESA_TPU_HOME", os.path.expanduser("~/.sesa_tpu"))
CHECKPOINT_DIR = os.path.join(BASE_DIR, "ckpts")
CUSTOM_MODELS_FILE = os.path.join(BASE_DIR, "custom_models.json")

SUPPORTED_MODEL_TYPES = [
    "bs_roformer",
    "mel_band_roformer",
    "mdx23c",
    "bandit_v2",
    "scnet",
    "htdemucs",
    "torchseg",
]


def _yaml(path: str = "a YAML config"):
    """The yaml module; without pyyaml, the error configs.load_config raises."""
    try:
        import yaml
    except ImportError:
        raise RuntimeError(f"{path}: reading YAML configs needs pyyaml; "
                           "pass a .json config instead") from None
    return yaml


def _is_yaml(path: str) -> bool:
    return path.lower().endswith((".yaml", ".yml"))


def _load_registry() -> Dict[str, Dict[str, dict]]:
    with open(os.path.join(_HERE, "model_registry.json")) as f:
        return json.load(f)


MODEL_CONFIGS = _load_registry()


# --------------------------------------------------------------------------
# URL and content hygiene
# --------------------------------------------------------------------------

def fix_huggingface_url(url: Optional[str]) -> Optional[str]:
    """HuggingFace /blob/ pages are HTML; /resolve/ serves the raw file."""
    if url and "huggingface.co" in url and "/blob/" in url:
        return url.replace("/blob/", "/resolve/")
    return url


_HTML_INDICATORS = (
    "<!doctype", "<html", "<head>", "<body>", "<script>", "<link rel=", "text/html",
)


def validate_yaml_content(content, filepath: Optional[str] = None):
    """Detect HTML masquerading as YAML. Returns (is_valid, error_message)."""
    text = content if isinstance(content, str) else content.decode("utf-8", errors="ignore")
    lower = text.lower()
    for ind in _HTML_INDICATORS:
        if ind in lower:
            where = f" ({filepath})" if filepath else ""
            return False, (
                f"Downloaded file{where} is an HTML page, not YAML. This usually "
                "means a HuggingFace /blob/ URL was used instead of /resolve/. "
                "Copy the raw file URL and retry."
            )
    return True, None


def preprocess_yaml_content(content: str) -> str:
    """Fix common community-config YAML problems: tabs and unquoted values
    containing colons (URLs) or backslashes (Windows paths)."""
    yaml = _yaml()
    if "\t" in content:
        content = content.replace("\t", "    ")
    fixed = []
    for line in content.split("\n"):
        stripped = line.strip()
        if not stripped or stripped.startswith("#"):
            fixed.append(line)
            continue
        m = re.match(r"^(\s*)([^:#]+?):\s+(.+)$", line)
        if m:
            indent, key, value = m.groups()
            quoted = (value.startswith('"') and value.endswith('"')) or (
                value.startswith("'") and value.endswith("'")
            )
            if (":" in value or "\\" in value) and not quoted:
                # Only quote values that YAML cannot already parse: blanket
                # quoting would corrupt valid flow collections
                # ('model: {dim: 512}' -> a string) and swallow inline
                # comments into values.
                try:
                    yaml.safe_load(f"k: {value}")
                    parses = True
                except yaml.YAMLError:
                    parses = False
                if not parses:
                    # single quotes: YAML doesn't interpret backslash
                    # escapes in them, so Windows paths survive (double
                    # quotes would not)
                    fixed.append(
                        f"{indent}{key}: "
                        f"'{value.replace(chr(39), chr(39) * 2)}'")
                    continue
        fixed.append(line)
    return "\n".join(fixed)


# --------------------------------------------------------------------------
# download manager
# --------------------------------------------------------------------------

def download_file(url: str, path: Optional[str] = None,
                  target_filename: Optional[str] = None,
                  validate_yaml: bool = True,
                  progress_cb=None) -> str:
    """Download ``url`` into ``path`` (default CHECKPOINT_DIR).

    Emits the reference's line protocol ([SESA_DOWNLOAD]name:percent,
    reference model.py:510-525) and validates YAML payloads. Existing
    files are kept. Returns the local file path.
    """
    url = fix_huggingface_url(url)
    encoded = quote(url, safe=":/")
    path = path or CHECKPOINT_DIR
    os.makedirs(path, exist_ok=True)
    filename = target_filename or os.path.basename(encoded)
    file_path = os.path.join(path, filename)
    if os.path.exists(file_path):
        return file_path

    import requests

    response = requests.get(url, stream=True, timeout=60)
    if response.status_code != 200:
        raise RuntimeError(f"download failed ({response.status_code}): {url}")

    total = int(response.headers.get("content-length", 0))
    is_yaml = filename.lower().endswith((".yaml", ".yml"))
    if is_yaml and validate_yaml:
        content = response.content
        ok, err = validate_yaml_content(content, file_path)
        if not ok:
            raise ValueError(err)
        with open(file_path, "wb") as f:
            f.write(content)
        return file_path

    done = 0
    last = -1
    first_bytes = b""
    print(f"[SESA_DOWNLOAD]START:{filename}", flush=True)
    # stream into a .part file and rename on success: an interrupted
    # download must never be cached as a complete checkpoint (the
    # os.path.exists fast path above would serve it forever)
    part_path = file_path + ".part"
    try:
        with open(part_path, "wb") as f:
            for chunk in response.iter_content(chunk_size=1 << 20):
                if len(first_bytes) < 512:
                    first_bytes += chunk[: 512 - len(first_bytes)]
                f.write(chunk)
                done += len(chunk)
                if total > 0:
                    pct = int(done * 100 / total)
                    if pct != last:
                        last = pct
                        print(f"[SESA_DOWNLOAD]{filename}:{pct}", flush=True)
                        if progress_cb:
                            progress_cb(filename, pct)
        if total > 0 and done < total:
            raise RuntimeError(
                f"truncated download: got {done} of {total} bytes for {url}")
        # checkpoints served as HTML pages (login walls, error pages with
        # 200, non-fixable /blob/ viewers) must fail HERE, not as an
        # opaque parse error at load time
        head = first_bytes.lstrip().lower()
        if head.startswith((b"<!doctype html", b"<html")):
            raise ValueError(
                f"downloaded file is an HTML page, not a checkpoint: {url}")
        os.replace(part_path, file_path)
    finally:
        if os.path.exists(part_path):
            os.remove(part_path)
    print(f"[SESA_DOWNLOAD]END:{filename}", flush=True)
    return file_path


# --------------------------------------------------------------------------
# config editing (reference model.py:294-421)
# --------------------------------------------------------------------------

def conf_edit(config_path: str, chunk_size: Optional[int], overlap: Optional[int],
              model_name: Optional[str] = None) -> None:
    """Patch inference.num_overlap / batch_size and training.use_amp in a
    downloaded YAML (or JSON) config, preserving the model's native
    audio.chunk_size. Backs up before editing and restores on any failure."""
    full = os.path.join(CHECKPOINT_DIR, os.path.basename(config_path))
    if not os.path.exists(full):
        raise FileNotFoundError(f"Configuration file not found: {full}")
    yaml = _yaml(full) if _is_yaml(full) else None

    backup = full + ".backup"
    shutil.copy2(full, backup)
    try:
        with open(full, encoding="utf-8") as f:
            original = f.read()
        ok, err = validate_yaml_content(original, full)
        if not ok:
            raise ValueError(err)
        if yaml is None:
            data = json.loads(original)
        else:
            content = preprocess_yaml_content(original)
            if content != original:
                with open(full, "w", encoding="utf-8") as f:
                    f.write(content)
            data = yaml.safe_load(content)
        if not isinstance(data, dict):
            raise ValueError(f"config is not a mapping: {full}")

        data.setdefault("training", {})["use_amp"] = True
        data.setdefault("audio", {})  # native chunk_size preserved untouched
        inf = data.setdefault("inference", {})
        if overlap is not None:
            inf["num_overlap"] = overlap
        if inf.get("batch_size", 1) == 1:
            inf["batch_size"] = 2

        with open(full, "w", encoding="utf-8") as f:
            if yaml is None:
                json.dump(data, f, indent=2)
            else:
                yaml.dump(data, f, default_flow_style=False, sort_keys=False)
        os.remove(backup)
    except Exception:
        if os.path.exists(backup):
            shutil.copy2(backup, full)
            os.remove(backup)
        raise


# --------------------------------------------------------------------------
# custom models (JSON CRUD, reference model.py:135-227)
# --------------------------------------------------------------------------

def load_custom_models() -> dict:
    if not os.path.exists(CUSTOM_MODELS_FILE):
        return {}
    try:
        with open(CUSTOM_MODELS_FILE, encoding="utf-8") as f:
            return json.load(f)
    except (json.JSONDecodeError, OSError):
        return {}


def save_custom_models(models: dict) -> None:
    os.makedirs(os.path.dirname(CUSTOM_MODELS_FILE), exist_ok=True)
    with open(CUSTOM_MODELS_FILE, "w", encoding="utf-8") as f:
        json.dump(models, f, indent=2, ensure_ascii=False)


def detect_model_type_from_url(checkpoint_url: str, config_url: Optional[str] = None):
    text = " ".join(filter(None, [checkpoint_url, config_url])).lower()
    patterns = [
        (r"bs[-_]?roformer|bsroformer", "bs_roformer"),
        (r"mel[-_]?band[-_]?roformer|melbandroformer|mbr", "mel_band_roformer"),
        (r"mdx23c", "mdx23c"),
        (r"bandit[-_]?v?2?", "bandit_v2"),
        (r"scnet", "scnet"),
        (r"htdemucs|demucs", "htdemucs"),
        (r"torchseg", "torchseg"),
    ]
    for pattern, model_type in patterns:
        if re.search(pattern, text):
            return model_type
    return None


def add_custom_model(model_name, model_type, checkpoint_url, config_url,
                     auto_detect=True):
    if not model_name or not model_name.strip():
        return False, "Model name is required"
    if not checkpoint_url or not checkpoint_url.strip():
        return False, "Checkpoint URL is required"
    if not config_url or not config_url.strip():
        return False, "Config URL is required"

    model_name = model_name.strip()
    checkpoint_url = fix_huggingface_url(checkpoint_url.strip())
    config_url = fix_huggingface_url(config_url.strip())

    if auto_detect and (not model_type or model_type == "auto"):
        model_type = detect_model_type_from_url(checkpoint_url, config_url)
        if not model_type:
            return False, "Could not auto-detect model type. Please select manually."
    if model_type not in SUPPORTED_MODEL_TYPES:
        return False, f"Unsupported model type: {model_type}"

    models = load_custom_models()
    if model_name in models:
        return False, f"Model '{model_name}' already exists"
    models[model_name] = {
        "model_type": model_type,
        "checkpoint_url": checkpoint_url,
        "config_url": config_url,
        "checkpoint_filename": os.path.basename(checkpoint_url.split("?")[0]),
        "config_filename": f"config_{model_name.replace(' ', '_').lower()}.yaml",
        "needs_conf_edit": True,
    }
    save_custom_models(models)
    return True, f"Model '{model_name}' added successfully"


def delete_custom_model(model_name):
    models = load_custom_models()
    if model_name not in models:
        return False, f"Model '{model_name}' not found"
    cfg = models.pop(model_name)
    for key in ("checkpoint_filename", "config_filename"):
        p = os.path.join(CHECKPOINT_DIR, cfg.get(key, ""))
        if cfg.get(key) and os.path.exists(p):
            try:
                os.remove(p)
            except OSError:
                pass
    save_custom_models(models)
    return True, f"Model '{model_name}' deleted successfully"


def get_custom_models_list():
    return [(name, cfg.get("model_type", "unknown"))
            for name, cfg in load_custom_models().items()]


def get_all_model_configs_with_custom():
    all_configs = dict(MODEL_CONFIGS)
    custom = load_custom_models()
    if custom:
        all_configs["Custom Models"] = {
            name: {
                "model_type": cfg["model_type"],
                "config_path": cfg["config_filename"],
                "start_check_point": cfg["checkpoint_filename"],
                "download_urls": [cfg["checkpoint_url"], cfg["config_url"]],
                "needs_conf_edit": cfg.get("needs_conf_edit", True),
            }
            for name, cfg in custom.items()
        }
    return all_configs


# --------------------------------------------------------------------------
# main resolution entry point (reference model.py:1769-1837)
# --------------------------------------------------------------------------

def get_model_config(clean_model: Optional[str] = None,
                     chunk_size: Optional[int] = None,
                     overlap: Optional[int] = None) -> Tuple[str, str, str]:
    """Resolve a display name to (model_type, config_path, checkpoint_path),
    downloading missing assets and applying conf_edit when requested.
    With no argument, returns the set of all known model names."""
    if clean_model is None:
        names = {m for cat in MODEL_CONFIGS.values() for m in cat}
        names.update(load_custom_models().keys())
        return names

    for category in MODEL_CONFIGS.values():
        if clean_model in category:
            cfg = category[clean_model]
            if cfg.get("unsupported"):
                # flagged in registry metadata (e.g. imagenet-encoder-zoo
                # checkpoints): fail typed BEFORE downloading assets
                raise NotImplementedError(
                    f"Model '{clean_model}' is not loadable: {cfg['unsupported']}")
            for url_entry in cfg["download_urls"]:
                if isinstance(url_entry, (tuple, list)):
                    download_file(url_entry[0], target_filename=url_entry[1])
                else:
                    download_file(url_entry)
            # bs_roformer_custom entries: the reference downloads and executes
            # the .py at custom_model_url (reference model.py:1796-1804); here
            # the architecture is resolved declaratively from the entry's
            # config.yaml by models/bs_roformer_custom.py: the
            # custom_model_url is intentionally never fetched.
            if cfg["needs_conf_edit"] and chunk_size is not None and overlap is not None:
                conf_edit(cfg["config_path"], chunk_size, overlap)
            return (
                cfg["model_type"],
                os.path.join(CHECKPOINT_DIR, os.path.basename(cfg["config_path"])),
                os.path.join(CHECKPOINT_DIR, os.path.basename(cfg["start_check_point"])),
            )

    custom = load_custom_models()
    if clean_model in custom:
        cfg = custom[clean_model]
        ckpt = os.path.join(CHECKPOINT_DIR, cfg["checkpoint_filename"])
        conf = os.path.join(CHECKPOINT_DIR, cfg["config_filename"])
        download_file(cfg["checkpoint_url"], target_filename=cfg["checkpoint_filename"])
        download_file(cfg["config_url"], target_filename=cfg["config_filename"])
        if cfg.get("needs_conf_edit", True) and chunk_size is not None and overlap is not None:
            conf_edit(conf, chunk_size, overlap, model_name=clean_model)
        return cfg["model_type"], conf, ckpt

    return "", "", ""


def get_model_chunk_size(model_name: str) -> Optional[int]:
    """Native audio.chunk_size from a model's already-downloaded config."""
    for category in get_all_model_configs_with_custom().values():
        if model_name in category:
            p = category[model_name].get("config_path", "")
            full = os.path.join(CHECKPOINT_DIR, os.path.basename(p)) if p else ""
            if full and os.path.exists(full):
                yaml = _yaml(full) if _is_yaml(full) else None
                try:
                    with open(full, encoding="utf-8") as f:
                        data = json.load(f) if yaml is None else yaml.safe_load(f)
                    if isinstance(data, dict):
                        cs = data.get("audio", {}).get("chunk_size")
                        if cs:
                            return int(cs)
                except Exception:
                    pass
    return None
