"""Input audio downloader: direct URLs, Google Drive, YouTube (counterpart
of sesa_tpu/download.py; reference download.py:28-241 ``download_callback``):
a direct URL is fetched with requests and converted to WAV, Google Drive
goes through gdown, YouTube through yt-dlp (client spoofing first, a
cookies file as the fallback). requests, gdown and yt-dlp are imported only
when their source is asked for; without them that source reports a clear
error instead of crashing.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

from sesa_tpu_torch import helpers


def _download_direct(url: str, dest_dir: str) -> str:
    import requests

    name = helpers.sanitize_filename(os.path.basename(url.split("?")[0]) or "input.wav")
    path = os.path.join(dest_dir, name)
    r = requests.get(url, stream=True, timeout=60)
    r.raise_for_status()
    with open(path, "wb") as f:
        for chunk in r.iter_content(chunk_size=1 << 20):
            f.write(chunk)
    return path


def _download_gdrive(url: str, dest_dir: str) -> str:
    try:
        import gdown
    except ImportError as e:
        raise RuntimeError("Google Drive downloads require the 'gdown' package") from e
    out = os.path.join(dest_dir, "gdrive_input")
    return gdown.download(url, out, fuzzy=True)


def _download_youtube(url: str, dest_dir: str, cookie_file: Optional[str] = None) -> str:
    try:
        import yt_dlp
    except ImportError as e:
        raise RuntimeError("YouTube downloads require the 'yt-dlp' package") from e

    opts = {
        "format": "bestaudio/best",
        "outtmpl": os.path.join(dest_dir, "%(title)s.%(ext)s"),
        "postprocessors": [{"key": "FFmpegExtractAudio", "preferredcodec": "wav"}],
        # iOS/Android client first (reference download.py), cookies fallback
        "extractor_args": {"youtube": {"player_client": ["ios", "android"]}},
    }
    try:
        with yt_dlp.YoutubeDL(opts) as ydl:
            info = ydl.extract_info(url, download=True)
            return os.path.splitext(ydl.prepare_filename(info))[0] + ".wav"
    except Exception:
        if not cookie_file:
            raise
        opts.pop("extractor_args", None)
        opts["cookiefile"] = cookie_file
        with yt_dlp.YoutubeDL(opts) as ydl:
            info = ydl.extract_info(url, download=True)
            return os.path.splitext(ydl.prepare_filename(info))[0] + ".wav"


def download_callback(url: str, cookie_file: Optional[str] = None
                      ) -> Tuple[Optional[str], str]:
    """Fetch an input URL into the workspace input dir → (path, status)."""
    helpers.setup_directories()
    helpers.clear_directory(helpers.INPUT_DIR)
    try:
        if "drive.google.com" in url:
            path = _download_gdrive(url, helpers.INPUT_DIR)
        elif "youtube.com" in url or "youtu.be" in url:
            path = _download_youtube(url, helpers.INPUT_DIR, cookie_file)
        else:
            path = _download_direct(url, helpers.INPUT_DIR)
        if not path or not os.path.exists(path):
            return None, "Download failed"
        path = helpers.convert_to_wav(path)
        return path, f"Downloaded: {os.path.basename(path)}"
    except Exception as e:
        return None, f"Download error: {e}"
