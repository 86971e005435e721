"""The port's registry held against sesa_tpu's on the CPU: the registry data,
URL and YAML hygiene, conf_edit, the download manager (a fake ``requests``),
custom-model CRUD and name resolution, each package in its own home under
``tmp_path``; then the port's own branches for .json configs and for a
machine without pyyaml."""

import json
import os
import sys
import types

import pytest
import yaml

import sesa_tpu.registry.models as JR
import sesa_tpu_torch.registry.models as PR
from sesa_tpu_torch.models.registry import MODEL_TYPES

URL_CASES = ["https://huggingface.co/u/r/blob/main/m.ckpt", "https://github.com/x", None,
             "https://huggingface.co/u/r/resolve/main/c.yaml"]
YAML_CASES = [
    "<!DOCTYPE html><html>...",
    "audio:\n  chunk_size: 352800\n",
    "<head><link rel=stylesheet></head>",
    b"model:\n  dim: 512\n",
]
PREPROCESS_CASES = [
    "model:\n\turl: https://x.com/a:b\n\tpath: C:\\models\\x\n\tdim: 512\n",
    "model: {dim: 512, depth: 12}\n",
    "# comment: here\naudio:\n  chunk_size: 485100  # native\n",
    "name: it's: broken\nwin: D:\\a\\b\n",
    "",
]
DETECT_CASES = ["https://x/MelBandRoformer_big.ckpt", "https://x/model_mdx23c.ckpt",
                "https://x/unknown.bin", "https://x/scnet_xl.ckpt", "https://x/htdemucs_ft.th",
                "https://x/model_bs_roformer_ep_317.ckpt"]
YAML_CONFIG = ("audio:\n  chunk_size: 485100\n  sample_rate: 44100\n"
               "model:\n\tdim: 384\n\turl: https://x.com/a:b\n"
               "inference:\n  batch_size: 1\n")


@pytest.fixture()
def homes(tmp_path, monkeypatch):
    """Each package's registry rooted in its own directory under tmp_path."""
    out = {}
    for name, mod in (("jax", JR), ("port", PR)):
        home = tmp_path / name
        (home / "ckpts").mkdir(parents=True)
        monkeypatch.setattr(mod, "BASE_DIR", str(home))
        monkeypatch.setattr(mod, "CHECKPOINT_DIR", str(home / "ckpts"))
        monkeypatch.setattr(mod, "CUSTOM_MODELS_FILE", str(home / "custom_models.json"))
        out[name] = home
    return out


def _both(fn):
    return fn(JR), fn(PR)


def test_registry_data_equals_jax():
    assert PR.MODEL_CONFIGS == JR.MODEL_CONFIGS
    assert PR.SUPPORTED_MODEL_TYPES == JR.SUPPORTED_MODEL_TYPES
    with open(os.path.join(os.path.dirname(PR.__file__), "model_registry.json"), "rb") as f:
        port_bytes = f.read()
    with open(os.path.join(os.path.dirname(JR.__file__), "model_registry.json"), "rb") as f:
        assert f.read() == port_bytes


def test_every_registry_model_type_is_ported():
    types_ = {e["model_type"] for cat in PR.MODEL_CONFIGS.values() for e in cat.values()}
    assert types_ <= set(MODEL_TYPES), types_ - set(MODEL_TYPES)
    assert set(PR.SUPPORTED_MODEL_TYPES) <= set(MODEL_TYPES)


@pytest.mark.parametrize("url", URL_CASES)
def test_fix_huggingface_url_matches_jax(url):
    a, b = _both(lambda m: m.fix_huggingface_url(url))
    assert a == b


@pytest.mark.parametrize("content", YAML_CASES)
@pytest.mark.parametrize("filepath", [None, "/x/c.yaml"])
def test_validate_yaml_content_matches_jax(content, filepath):
    a, b = _both(lambda m: m.validate_yaml_content(content, filepath))
    assert a == b


@pytest.mark.parametrize("raw", PREPROCESS_CASES)
def test_preprocess_yaml_content_matches_jax(raw):
    a, b = _both(lambda m: m.preprocess_yaml_content(raw))
    assert a == b


@pytest.mark.parametrize("url", DETECT_CASES)
def test_detect_model_type_matches_jax(url):
    a, b = _both(lambda m: m.detect_model_type_from_url(url))
    assert a == b


@pytest.mark.parametrize("content, overlap", [
    (YAML_CONFIG, 4),
    ("audio:\n  chunk_size: 352800\ninference:\n  batch_size: 4\n  num_overlap: 8\n", None),
])
def test_conf_edit_leaves_the_same_bytes(homes, content, overlap):
    for home in homes.values():
        (home / "ckpts" / "c.yaml").write_text(content)
    _both(lambda m: m.conf_edit("c.yaml", chunk_size=123, overlap=overlap))
    jax_bytes, port_bytes = ((homes[k] / "ckpts" / "c.yaml").read_bytes() for k in homes)
    assert port_bytes == jax_bytes
    data = yaml.safe_load(port_bytes)
    assert data["audio"]["chunk_size"] in (485100, 352800)  # native kept
    assert data["training"]["use_amp"] is True
    assert not os.path.exists(str(homes["port"] / "ckpts" / "c.yaml") + ".backup")


def test_conf_edit_restores_the_backup_on_html(homes):
    for home in homes.values():
        (home / "ckpts" / "bad.yaml").write_text("<html>nope</html>")
    for mod in (JR, PR):
        with pytest.raises(ValueError, match="HTML page"):
            mod.conf_edit("bad.yaml", 1, 2)
    for home in homes.values():
        assert (home / "ckpts" / "bad.yaml").read_text() == "<html>nope</html>"
        assert not (home / "ckpts" / "bad.yaml.backup").exists()


def test_conf_edit_patches_a_json_config_without_pyyaml(homes, monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)
    path = homes["port"] / "ckpts" / "c.json"
    path.write_text(json.dumps({"audio": {"chunk_size": 485100},
                                "inference": {"batch_size": 1}}))
    PR.conf_edit("c.json", chunk_size=123, overlap=4)
    assert json.loads(path.read_text()) == {
        "audio": {"chunk_size": 485100},
        "inference": {"batch_size": 2, "num_overlap": 4},
        "training": {"use_amp": True}}
    (homes["port"] / "ckpts" / "c.yaml").write_text(YAML_CONFIG)
    with pytest.raises(RuntimeError, match="needs pyyaml"):
        PR.conf_edit("c.yaml", 1, 2)
    assert (homes["port"] / "ckpts" / "c.yaml").read_text() == YAML_CONFIG


# --------------------------------------------------------------------------
# download manager
# --------------------------------------------------------------------------

class _Response:
    def __init__(self, body, status=200, length=None):
        self.status_code = status
        self.content = body
        self.headers = {"content-length": str(len(body) if length is None else length)}
        self._body = body

    def iter_content(self, chunk_size=1):
        for i in range(0, len(self._body), 4096):
            yield self._body[i:i + 4096]


def _fake_requests(response, calls):
    mod = types.ModuleType("requests")

    def get(url, stream=False, timeout=None):
        calls.append(url)
        return response

    mod.get = get
    return mod


CKPT = bytes(range(256)) * 64  # 16 KiB
DOWNLOAD_CASES = {
    "ok": (_Response(CKPT), "m.ckpt", None),
    "truncated": (_Response(CKPT, length=len(CKPT) + 100), "m.ckpt", RuntimeError),
    "html": (_Response(b"  <!DOCTYPE html><html>login</html>" + b" " * 9000), "m.ckpt", ValueError),
    "yaml_html": (_Response(b"<html>viewer</html>"), "c.yaml", ValueError),
    "yaml_ok": (_Response(b"audio:\n  chunk_size: 1\n"), "c.yaml", None),
    "status": (_Response(b"", status=404), "m.ckpt", RuntimeError),
}


@pytest.mark.parametrize("case", sorted(DOWNLOAD_CASES))
def test_download_file_matches_jax(homes, monkeypatch, capsys, case):
    response, name, error = DOWNLOAD_CASES[case]
    url = f"https://huggingface.co/u/r/blob/main/{name}"
    results = {}
    for key, mod in (("jax", JR), ("port", PR)):
        calls = []
        monkeypatch.setitem(sys.modules, "requests", _fake_requests(response, calls))
        if error is None:
            path = mod.download_file(url)
            with open(path, "rb") as f:
                body = f.read()
            results[key] = (os.path.relpath(path, homes[key]), body)
        else:
            with pytest.raises(error) as e:
                mod.download_file(url)
            results[key] = str(e.value).replace(str(homes[key]), "<home>")
        assert calls == ["https://huggingface.co/u/r/resolve/main/" + name]
        assert sorted(os.listdir(homes[key] / "ckpts")) == ([name] if error is None else [])
        results[key + "_out"] = capsys.readouterr().out
    assert results["port"] == results["jax"]
    assert results["port_out"] == results["jax_out"]
    if case == "ok":
        assert "[SESA_DOWNLOAD]START:m.ckpt" in results["port_out"]
        assert "[SESA_DOWNLOAD]m.ckpt:100" in results["port_out"]
    if case == "truncated":
        assert "truncated download" in results["port"]


def test_download_file_keeps_a_file_in_place(homes, monkeypatch):
    calls = []
    monkeypatch.setitem(sys.modules, "requests", _fake_requests(_Response(CKPT), calls))
    (homes["port"] / "ckpts" / "m.ckpt").write_bytes(b"mine")
    path = PR.download_file("https://x/m.ckpt")
    assert calls == [] and open(path, "rb").read() == b"mine"


# --------------------------------------------------------------------------
# custom models and name resolution
# --------------------------------------------------------------------------

def _crud(mod):
    log = [
        mod.add_custom_model("My Model", "auto",
                             "https://huggingface.co/u/r/blob/main/my_bs_roformer.ckpt",
                             "https://huggingface.co/u/r/blob/main/cfg.yaml"),
        mod.add_custom_model("My Model", "auto", "https://x/other_bs_roformer.ckpt",
                             "https://x/c.yaml"),
        mod.add_custom_model("Unknown", "auto", "https://x/a.bin", "https://x/c.yaml"),
        mod.add_custom_model("Mdx", "mdx23c", "https://x/m.ckpt?dl=1", "https://x/c.yaml"),
        mod.add_custom_model("Bad", "nope", "https://x/m.ckpt", "https://x/c.yaml"),
        mod.add_custom_model(" ", "auto", "https://x/m.ckpt", "https://x/c.yaml"),
        mod.get_custom_models_list(),
    ]
    with open(mod.CUSTOM_MODELS_FILE, "rb") as f:
        saved = f.read()
    log.append(mod.get_all_model_configs_with_custom()["Custom Models"])
    log.append(mod.delete_custom_model("Mdx"))
    log.append(mod.delete_custom_model("Mdx"))
    with open(mod.CUSTOM_MODELS_FILE, "rb") as f:
        after = f.read()
    return log, saved, after


def test_custom_model_crud_matches_jax(homes):
    (jlog, jsaved, jafter), (plog, psaved, pafter) = _both(_crud)
    assert plog == jlog
    assert psaved == jsaved and pafter == jafter
    assert json.loads(pafter)["My Model"]["model_type"] == "bs_roformer"


def _stage(home, urls):
    """Put every file a registry entry downloads in place (no network)."""
    for entry in urls:
        target = entry[1] if isinstance(entry, (list, tuple)) else os.path.basename(entry)
        path = home / "ckpts" / target
        path.write_text(YAML_CONFIG if target.endswith((".yaml", ".yml")) else "weights")


def test_get_model_config_matches_jax(homes, monkeypatch):
    calls = []
    monkeypatch.setitem(sys.modules, "requests", _fake_requests(_Response(b""), calls))
    name = "VOCALS-BS-Roformer_1297 (by viperx)"
    entry = PR.MODEL_CONFIGS["Vocal Models"][name]
    custom_cfg = "config_my_model.yaml"
    for key, mod in (("jax", JR), ("port", PR)):
        _stage(homes[key], entry["download_urls"])
        mod.add_custom_model("My Model", "bs_roformer", "https://x/my.ckpt", "https://x/c.yaml")
        _stage(homes[key], ["https://x/my.ckpt", ["https://x/c.yaml", custom_cfg]])
    for args in ((name, 352800, 2), (name, None, None), ("My Model", 352800, 4), ("nobody",)):
        got = {}
        for key, mod in (("jax", JR), ("port", PR)):
            res = mod.get_model_config(*args)
            got[key] = tuple(os.path.relpath(p, homes[key]) if p else p for p in res)
        assert got["port"] == got["jax"], args
    for key in homes:
        got[key] = [(homes[key] / "ckpts" / f).read_bytes() for f in (
            os.path.basename(entry["config_path"]), custom_cfg)]
    assert got["port"] == got["jax"]
    assert calls == []
    assert _both(lambda m: m.get_model_chunk_size(name)) == (485100, 485100)
    assert _both(lambda m: m.get_model_chunk_size("My Model")) == (485100, 485100)
    assert _both(lambda m: m.get_model_config())[1] == JR.get_model_config()


def test_get_model_config_reads_json_configs_without_pyyaml(homes, monkeypatch):
    """A custom entry with a .json config and no conf_edit resolves on a
    host without pyyaml, and its native chunk is read."""
    monkeypatch.setitem(sys.modules, "yaml", None)
    monkeypatch.setitem(sys.modules, "requests", None)
    ckpts = homes["port"] / "ckpts"
    PR.save_custom_models({"Json Model": {
        "model_type": "bs_roformer", "checkpoint_url": "https://x/m.ckpt",
        "config_url": "https://x/c.json", "checkpoint_filename": "m.ckpt",
        "config_filename": "c.json", "needs_conf_edit": False}})
    (ckpts / "m.ckpt").write_text("weights")
    (ckpts / "c.json").write_text(json.dumps({"audio": {"chunk_size": 131072}}))
    assert PR.get_model_config("Json Model", 352800, 2) == (
        "bs_roformer", str(ckpts / "c.json"), str(ckpts / "m.ckpt"))
    assert PR.get_model_chunk_size("Json Model") == 131072
    (ckpts / "c.json").unlink()
    PR.save_custom_models({"Yaml Model": dict(
        PR.load_custom_models().get("Json Model", {}), model_type="bs_roformer",
        checkpoint_url="https://x/m.ckpt", config_url="https://x/c.yaml",
        checkpoint_filename="m.ckpt", config_filename="c.yaml", needs_conf_edit=False)})
    (ckpts / "c.yaml").write_text(YAML_CONFIG)
    with pytest.raises(RuntimeError, match="needs pyyaml"):
        PR.get_model_chunk_size("Yaml Model")
