"""Display-name -> short-filename mapping for output naming (counterpart of
sesa_tpu/clean_model.py; reference clean_model.py:37-118): a 65-entry
curated mapping (data in assets/clean_names.json) with a regex fallback that
strips parentheticals and non-alphanumerics.
"""

from __future__ import annotations

import json
import os
import re

_HERE = os.path.dirname(os.path.abspath(__file__))

with open(os.path.join(_HERE, "assets", "clean_names.json"), encoding="utf-8") as f:
    CLEAN_NAMES = json.load(f)


def clean_model_name(model: str) -> str:
    """Clean and standardize a model display name for filenames."""
    if model in CLEAN_NAMES:
        return CLEAN_NAMES[model]
    cleaned = re.sub(r"\s*\(.*?\)", "", model)  # remove parenthetical info
    cleaned = cleaned.replace("-", "_")
    return "".join(ch for ch in cleaned if ch.isalnum() or ch == "_")


def shorten_filename(filename: str, max_length: int = 30) -> str:
    base, ext = os.path.splitext(filename)
    if len(base) <= max_length:
        return filename
    return base[:15] + "..." + base[-10:] + ext
