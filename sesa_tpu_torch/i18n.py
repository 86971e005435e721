"""Locale auto-detection + JSON string tables, 11 languages (counterpart
of sesa_tpu/i18n.py).

Functional parity with reference assets/i18n/i18n.py:10-54; the tables are
the JAX package's, copied under sesa_tpu_torch/assets/i18n/languages (two
upstream files repaired to valid JSON there).
"""

from __future__ import annotations

import json
import os
from pathlib import Path


def _default_locale() -> str:
    """locale.getdefaultlocale is deprecated (removal slated for 3.15);
    use getlocale with env-var fallbacks instead."""
    import locale

    try:
        lang = locale.getlocale()[0]
    except Exception:
        lang = None
    if not lang:
        for var in ("LC_ALL", "LC_MESSAGES", "LANG"):
            v = os.environ.get(var)
            if v and v not in ("C", "POSIX"):
                lang = v.split(".")[0]
                break
    return lang or "en_US"

_HERE = os.path.dirname(os.path.abspath(__file__))
LANGUAGE_PATH = os.path.join(_HERE, "assets", "i18n", "languages")
APP_CONFIG_PATH = os.path.join(_HERE, "assets", "config.json")


class I18nAuto:
    def __init__(self, language: str | None = None):
        override = False
        lang_prefix = "auto"
        try:
            with open(APP_CONFIG_PATH, encoding="utf8") as f:
                lang_config = json.load(f).get("lang", {})
            override = lang_config.get("override", False)
            lang_prefix = lang_config.get("selected_lang", "auto")
        except (FileNotFoundError, json.JSONDecodeError, KeyError):
            pass

        self.language = lang_prefix
        if not override:
            language = language or _default_locale()
            prefix = language[:2].lower() if language else "en"
            if prefix == "zh":
                # the Chinese table ships under the upstream filename typo
                # 'zn_cn.json' (carried for data parity) — map zh_* to it
                prefix = "zn"
            available = self.available_languages()
            matching = [l for l in available if l.startswith(prefix)]
            self.language = matching[0] if matching else "en_us"

        self.language_map = self._load(self.language)

    @staticmethod
    def available_languages():
        return sorted(p.stem for p in Path(LANGUAGE_PATH).glob("*.json"))

    @staticmethod
    def _load(language: str) -> dict:
        path = Path(LANGUAGE_PATH) / f"{language}.json"
        if not path.exists():
            path = Path(LANGUAGE_PATH) / "en_us.json"
        with open(path, encoding="utf-8") as f:
            return json.load(f)

    def __call__(self, key: str) -> str:
        return self.language_map.get(key, key)
